"""The port's stylize slice against the JAX package, on the CPU (the JAX
side under ``jax.jit`` where it jits), with inputs drawn from numpy
generators: the camera schedule, the backgrounds, phase A, one phase-B
step and one composed ``train_view``. Floater pruning is held in
tests/test_torch_occupancy.py, the analytic normals in
tests/test_torch_render.py, the derived budget and the CLI in
tests/test_torch_stylize_cli.py.

Tolerances:
* the schedule (poses, descriptions, view order, stride offsets,
  background keys): exact, and the numpy generators end in the same state;
  rays within 1e-6 (f32 ray generation in XLA and PyTorch);
* backgrounds: white, black and the chessboard exact; the noise background
  is drawn from a torch generator (not held against JAX's jax.random draw);
* phase A: 2e-3 absolute with bf16 tables (the render pin), 1e-5 with f32;
* one phase-B step (and the gradients of a composed train_view): per leaf
  against its max|g|, f32 tables 1e-4; bf16 tables 2e-3 for the MLP and
  variance leaves and 1e-1 for the table leaves, the bounds of
  tests/test_torch_train.py:11-18 (bf16 cotangents add in other orders).
  The composed fine step with bf16 tables adds 16 patches' bf16
  cotangents: its table leaves are held at 2e-1 (measured 1.6e-1 on the
  4^3 grid, whose 27 cells take every sample's corners; the JAX package's
  own jit and eager table gradients differ by 1.6e-1), its MLP leaves at
  2e-3 (measured 1.9e-4);
* a composed train_view: the SDS image gradient 4.0e-3 absolute (the bound
  of tests/test_torch_toy_guidance.py), the Adam step within 2 lr where
  a gradient is near 0 (Adam's first step is lr x sign(g)) and 1e-6 where
  |g| > 1e-2 max|g|; the refreshed and pruned grid within the refresh bound
  of tests/test_torch_train.py (512^2/4 x 1e-6).

JAX draws SDS's t and noise and the noise backgrounds from jax.random, the
port from torch generators: the composed step injects them into both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avatarcraft_tpu.cameras import pose2rays as jax_pose2rays
from avatarcraft_tpu.cameras import style_360_path as jax_style_360_path
from avatarcraft_tpu.cameras.rays import sparse_ray_sampling as jax_sparse_ray_sampling
from avatarcraft_tpu.models import diffusion as jdiff
from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.models import toy_guidance as jtoy
from avatarcraft_tpu.ops.grid_encoder import PyramidSpec as JaxPyramidSpec
from avatarcraft_tpu.utils import background as jbg
from avatarcraft_tpu.workloads import stylize as jsty
from avatarcraft_tpu_torch import bench
from avatarcraft_tpu_torch.cameras import pose2rays, sparse_ray_sampling, style_360_path
from avatarcraft_tpu_torch.cli import stylize_cli
from avatarcraft_tpu_torch.models import diffusion, sd, toy_guidance
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.utils import background
from avatarcraft_tpu_torch.utils.checkpoint import leaves, map_leaves, params_from_jax
from avatarcraft_tpu_torch.workloads import stylize

FIELD_ATOL = 1e-5
RENDER_ATOL = 2e-3
GRID_ATOL = 512.0**2 / 4 * 1e-6
SDS_ATOL = 4.02e-3
# per leaf, against its max|g|: (MLP and variance, tables)
GRAD_REL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-3, 1e-1)}
TABLE_LEAVES = ("['grids']", "['planes']")
# a fine step's bf16 table leaves: 16 patches of bf16 cotangents, each added
# in its own order; the JAX package's own jit and eager table gradients of
# one loss differ by up to 1.6e-1 x max|g| (tests/test_torch_train.py:16-17)
BF16_FINE_TABLE_REL = 2e-1

JAX_FCFG = jnsr.FieldConfig(
    encoder="tpu_pyramid",
    pyramid=JaxPyramidSpec(grid_resolutions=(4, 8), grid_dim=2, plane_resolutions=(17,), plane_dim=2),
    packed_dtype="float32",
)
JAX_TINY = jtoy.ToyGuidanceConfig(
    image_size=16, emb_dim=8, seq_len=2, block_out_channels=(8, 16), layers_per_block=1,
    attention_head_dim=2, norm_groups=4, attn_blocks=(False, True),
)
TINY = toy_guidance.ToyGuidanceConfig(**dataclasses.asdict(JAX_TINY))



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: tier-1 runs six
    pytest workers on the machine's cores, and workers whose torch ops each
    spread over every core oversubscribe it (a CPU-heavy test then runs up
    to ten times slower than alone). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_fcfg(jcfg):
    return nsr.FieldConfig(**{
        **dataclasses.asdict(jcfg),
        "grid": nsr.HashGridSpec(**dataclasses.asdict(jcfg.grid)),
        "pyramid": nsr.PyramidSpec(**dataclasses.asdict(jcfg.pyramid)),
    })


def _t(a):
    return torch.from_numpy(np.array(a))


def _field(seed=0, bias=-1.0):
    """A small field whose SDF depends on the tables and has a surface."""
    rng = np.random.default_rng(seed)
    jparams = jnsr.init_field_params(jax.random.PRNGKey(seed), JAX_FCFG)
    for key in ("grids", "planes"):
        jparams[key] = [jnp.asarray(rng.normal(size=t.shape).astype(np.float32) * 0.3) for t in jparams[key]]
    v = rng.normal(size=jparams["sdf"][0]["v"].shape).astype(np.float32) * 0.3
    jparams["sdf"][0] = {**jparams["sdf"][0], "v": jnp.asarray(v), "g": jnp.linalg.norm(v, axis=1)}
    jparams["sdf"][-1]["b"] = jparams["sdf"][-1]["b"].at[0].add(bias)
    return jparams


def _port(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _scene(rng, n_rays, R=17):
    grid = np.where(rng.random((R, R, R)) < 0.6, 50.0, 0.5).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32) * 0.25 + np.asarray([0, 0, 1], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(np.asarray([[0.1, -0.2, -2.6]], np.float32), (n_rays, 1))
    return grid, o, d.astype(np.float32)


def _assert_grads(got: dict, want, packed_dtype: str, rel_table: float | None = None):
    """Per leaf against max|g|: ``got`` the port's tree, ``want`` JAX's."""
    rel_mlp, table = GRAD_REL[packed_dtype]
    rel_table = table if rel_table is None else rel_table
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [jax.tree_util.keystr(p) for p, _ in gl] == [jax.tree_util.keystr(p) for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        w = np.asarray(w)
        name = jax.tree_util.keystr(path)
        scale = np.abs(w).max()
        assert scale > 0, name
        rel = rel_table if name.startswith(TABLE_LEAVES) else rel_mlp
        np.testing.assert_allclose(np.asarray(g), w, atol=rel * scale, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# schedule and backgrounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_rate,noise", [(0.2, True), (0.5, True), (0.0, False)])
def test_style_360_path_matches_jax(head_rate, noise):
    kw = dict(add_noise=noise, noise_scale=2.0, style_head=True, head_offset=0.423, head_rate=head_rate,
              head_dist=0.45)
    a_rng, b_rng = np.random.default_rng(7), np.random.default_rng(7)
    poses, descs = style_360_path(np.zeros(3), np.array([0.0, 1.0, 0.0]), 1.8, 40, rng=a_rng, **kw)
    jposes, jdescs = jax_style_360_path(np.zeros(3), np.array([0.0, 1.0, 0.0]), 1.8, 40, rng=b_rng, **kw)
    np.testing.assert_array_equal(poses, jposes)
    assert descs == jdescs and poses.dtype == np.float32
    assert a_rng.bit_generator.state == b_rng.bit_generator.state
    assert len(poses) == stylize_cli.views_per_epoch(
        stylize.StylizeConfig(n_cap=40, coarse_epochs=1, coarse_head=head_rate), 0)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_sparse_ray_sampling_matches_jax(stride):
    pose = bench.bench_poses()[3]
    ro, rd = pose2rays(16, 16, pose, device="cpu")
    jro, jrd = jax_pose2rays(16, 16, pose)
    a_rng, b_rng = np.random.default_rng(3), np.random.default_rng(3)
    got = sparse_ray_sampling(ro.reshape(16, 16, 3), rd.reshape(16, 16, 3), stride, a_rng)
    want = jax_sparse_ray_sampling(np.asarray(jro).reshape(16, 16, 3), np.asarray(jrd).reshape(16, 16, 3), stride,
                                   b_rng)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (16 // stride, 16 // stride, 3)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0)
    assert a_rng.bit_generator.state == b_rng.bit_generator.state


def test_select_background_matches_jax():
    for key in (0, 1, 3, 4, 7):  # key % 4, as the JAX package takes it
        got = background.select_background(64 * 64, key, device="cpu")
        want = np.asarray(jbg.select_background(64 * 64, key, jax.random.PRNGKey(0)))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.float32 and got.shape == (64 * 64, 3)
    gen = torch.Generator().manual_seed(0)
    noise = background.select_background(4096, 2, gen, device="cpu")
    assert torch.equal(noise[:, 0], noise[:, 2]) and 0.0 <= float(noise.min()) and float(noise.max()) <= 1.0
    assert abs(float(noise.mean()) - 0.5) < 0.01 and abs(float(noise[:, 0].std()) - 0.1) < 0.01
    assert torch.equal(noise, background.select_background(4096, 2, torch.Generator().manual_seed(0), "cpu"))
    with pytest.raises(ValueError, match="Generator"):
        background.select_background(16, 2, device="cpu")


# ---------------------------------------------------------------------------
# phase A, phase B
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed_dtype,atol", [("float32", FIELD_ATOL), ("bfloat16", RENDER_ATOL)])
def test_phaseA_render_fast_matches_jax(rng, packed_dtype, atol):
    jcfg = dataclasses.replace(JAX_FCFG, packed_dtype=packed_dtype)
    jfast = jnsr.FastRenderConfig(n_probes=32, k_samples=8, sample_budget=120)
    fast = nsr.FastRenderConfig(n_probes=32, k_samples=8, sample_budget=120)
    jparams = _field()
    grid, o, d = _scene(rng, 64)
    bg = rng.random((64, 3)).astype(np.float32)
    want = jsty.make_phaseA_render_fast(jcfg, jfast, 16)(jparams, o, d, bg, grid, jax.random.PRNGKey(0))
    got = stylize.make_phaseA_render_fast(_port_fcfg(jcfg), fast, 16)(_port(jparams), _t(o), _t(d), _t(bg), _t(grid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)


def _grad_store():
    """An optax transformation whose state is the last gradient and whose
    update is zero: make_phaseB_step_fast's step then returns the summed
    patch gradients as its opt_state."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def _port_phaseB_grads(params, fcfg, fast, gt_params, o, d, g_rgb, bg, grid, chunk, use_opacity):
    """The port's phase B of one step as the trainer runs it: the tables
    gathered and packed in f32 once, the patches backpropagate into
    detached copies, one backward through the packing. Returns the
    gradient tree."""
    params = map_leaves(params, lambda t: t.clone().requires_grad_())
    packed32 = nsr.materialize_field_tables(params, dataclasses.replace(fcfg, packed_dtype="float32"))
    tables = map_leaves(packed32, lambda t: t.detach().requires_grad_())
    gt = (gt_params, nsr.network_field_fns(gt_params, fcfg, fast.bound))
    step = stylize.make_phaseB_step_fast(fcfg, fast, 0.01, use_opacity, chunk, 1e5)
    loss = step(params, tables, gt, _t(o), _t(d), _t(g_rgb), _t(bg), _t(grid))
    torch.autograd.backward(leaves(packed32), [t.grad for t in leaves(tables)])
    return loss, map_leaves(params, lambda t: t.grad.numpy())


@pytest.mark.parametrize("packed_dtype,normal_mode,use_opacity", [
    ("float32", "fd4", True), ("bfloat16", "fd4", True), ("float32", "analytic", True),
    ("bfloat16", "analytic", False),
])
def test_phaseB_step_fast_matches_jax(rng, packed_dtype, normal_mode, use_opacity):
    """One phase-B step over 4 patches of 32 rays, against the JAX
    package's make_phaseB_step_fast (its patch gradients summed)."""
    jcfg = dataclasses.replace(JAX_FCFG, packed_dtype=packed_dtype)
    jfast = jnsr.FastRenderConfig(n_probes=32, k_samples=8, normal_mode=normal_mode)
    fast = nsr.FastRenderConfig(n_probes=32, k_samples=8, normal_mode=normal_mode)
    jparams, jgt = _field(0), _field(1, bias=-0.8)
    grid, o, d = _scene(rng, 128)
    g_rgb = rng.normal(size=(128, 3)).astype(np.float32) * 0.1
    bg = rng.random((128, 3)).astype(np.float32)
    tx = _grad_store()
    step = jsty.make_phaseB_step_fast(jcfg, jfast, tx, 0.01, use_opacity, 32, 1e5)
    _, want = step(jparams, jgt, tx.init(jparams), o, d, g_rgb, bg, grid, jax.random.PRNGKey(0))
    _, got = _port_phaseB_grads(_port(jparams), _port_fcfg(jcfg), fast, _port(jgt), o, d, g_rgb, bg, grid, 32,
                                use_opacity)
    _assert_grads(got, want, packed_dtype)


# ---------------------------------------------------------------------------
# one composed SDS step
# ---------------------------------------------------------------------------


def _trainers(packed_dtype, cfg_kw, budget):
    """A JAX and a port StylizeTrainer from one small field, the TINY toy
    guidance (JAX init), one grid; noise backgrounds, t and the SDS noise
    injected into both."""
    jcfg = dataclasses.replace(JAX_FCFG, packed_dtype=packed_dtype)
    fcfg = _port_fcfg(jcfg)
    jparams, jgt = _field(0), _field(1, bias=-0.8)
    grid = np.where(np.random.default_rng(9).random((17, 17, 17)) < 0.6, 50.0, 0.5).astype(np.float32)
    jtoy_params = jtoy.init_toy_params(jax.random.PRNGKey(2), JAX_TINY)
    embs = np.asarray(jtoy.style_embeddings(JAX_TINY))
    jguide = jdiff.SDSGuidance(jtoy.make_toy_modules(jtoy_params, JAX_TINY))
    guide = diffusion.SDSGuidance(toy_guidance.make_toy_modules(
        sd.params_from_jax(jax.tree_util.tree_map(np.asarray, jtoy_params), "cpu"), TINY, _t(embs)))
    jfast = jnsr.FastRenderConfig(n_probes=32, k_samples=8, sample_budget=budget)
    fast = nsr.FastRenderConfig(n_probes=32, k_samples=8, sample_budget=budget)
    cfg = dict(tgt_text="lava", H=32, W=32, batch_size=64, n_cap=8, lr=5e-3, sampler="fast", **cfg_kw)
    jtr = jsty.StylizeTrainer(jsty.StylizeConfig(**cfg), jcfg, jguide, jparams, jgt, grid=jnp.asarray(grid),
                              fast_cfg=jfast)
    tr = stylize.StylizeTrainer(stylize.StylizeConfig(**cfg), fcfg, guide, _port(jparams), _port(jgt),
                                grid=_t(grid), fast_cfg=fast)
    return jtr, tr, jguide, guide


@pytest.mark.parametrize("packed_dtype,epoch,rel_table", [
    ("float32", 0, None), ("float32", 1, None), ("bfloat16", 0, None), ("bfloat16", 1, BF16_FINE_TABLE_REL),
])
def test_train_view_matches_jax(monkeypatch, packed_dtype, epoch, rel_table):
    """One train_view: coarse (an 8x8 frame, one patch, resized up to the
    guidance's 16x16) or fine (32x32, 16 patches, the antialiased
    downscale), then a grid refresh with pruning and the clip guard."""
    rng = np.random.default_rng(11)
    jtr, tr, jguide, guide = _trainers(packed_dtype, dict(coarse_epochs=1, fine_epochs=1, grid_update_every=1),
                                       budget=300)
    t_inj, noise = 617, rng.normal(size=(1, 3, 16, 16)).astype(np.float32)
    bg_noise = rng.random((32 * 32, 3)).astype(np.float32)
    seen = {}

    def jsds(key, emb, img, gs, pred_depth=None):
        seen["jax"] = jguide.sds_image_grad(key, emb, img, gs, t_override=t_inj, noise_override=noise)
        return seen["jax"]

    def sds(emb, img, gs, pred_depth=None, **kw):
        seen["port"] = diffusion.SDSGuidance.sds_image_grad(guide, emb, img, gs, t_override=t_inj,
                                                             noise_override=_t(noise))
        return seen["port"]

    def fixed_noise(select, to_array):
        def pick(n, key_id, *args, **kw):
            if key_id % 4 == 2:
                return to_array(bg_noise[:n])
            return select(n, key_id, *args, **kw)
        return pick

    monkeypatch.setattr(jguide, "sds_image_grad_jit", jsds)
    monkeypatch.setattr(guide, "sds_image_grad", sds)
    monkeypatch.setattr(jsty, "select_background", fixed_noise(jbg.select_background, jnp.asarray))
    monkeypatch.setattr(stylize, "select_background", fixed_noise(background.select_background, _t))

    for trainer in (jtr, tr):
        poses, descs = trainer.epoch_poses(epoch)
        i = int(trainer.rng.permutation(len(poses))[0])
        trainer.train_view(poses[i], descs[i], epoch)
    assert jtr.rng.bit_generator.state == tr.rng.bit_generator.state
    np.testing.assert_allclose(seen["port"].numpy(), np.asarray(seen["jax"]), atol=SDS_ATOL, rtol=0)
    assert np.abs(np.asarray(seen["jax"])).max() > 1e-3

    # the gradients, from Adam's first moments (0.1 x g after one step)
    mu = jtr.opt_state[0].mu
    moments = map_leaves(tr.rest, lambda t: tr.opt.state[t]["exp_avg"])
    table = torch.cat([tr.opt.state[s]["exp_avg"] for s in tr.shards])
    _assert_grads(map_leaves(tr.splice(moments, table), lambda t: t.numpy()), mu, packed_dtype, rel_table)

    # the step itself: Adam's first update is lr x sign(g) where |g| >> eps
    gl = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jtr.params_style))
    pl = jax.tree_util.tree_leaves(map_leaves(tr.params(), lambda t: t.numpy()))
    for w, g, m in zip(gl, pl, jax.tree_util.tree_leaves(mu)):
        m = np.asarray(m)
        big = np.abs(m) > 1e-2 * np.abs(m).max()
        np.testing.assert_allclose(g[big], w[big], atol=1e-6, rtol=0)
        np.testing.assert_allclose(g, w, atol=2 * 5e-3, rtol=0)

    # the refresh at step 1, pruned, and the clip guard on the same grid
    np.testing.assert_allclose(tr.grid.numpy(), np.asarray(jtr.grid), atol=GRID_ATOL, rtol=0)
    assert tr.fast_cfg.sample_budget == jtr.fast_cfg.sample_budget
    assert tr.stats["refreshes"] == 1
