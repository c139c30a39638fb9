"""The parity stylize trainers of the PyTorch port against the JAX package,
on the CPU (the JAX side under ``jax.jit`` where it jits), at small widths:
make_phaseA_render and make_phaseB_step, one composed parity train_view of
StylizeTrainer and of MultiPromptTrainer at P = 2, the ground-truth render
that shares its patch's jitter, the multi-prompt phase B against the
single-prompt trainer, and the stylize CLI at its default sampler with
pyramid and hash-grid checkpoints.

JAX draws the stratified jitter from jax.random keys, the port from a
torch generator; a stream cannot be carried from one to the other, so the
comparisons with JAX render without jitter on both sides (a test-only
override of the trainers' ``rcfg``: 6+6 samples in rounds of 3, no jitter,
fd7). The jitter itself is held by the sharing test.

Tolerances: phase A 1e-5 with f32 tables and 2e-3 with bf16, the SDS
image gradient 4.02e-3, the Adam step 1e-6 where |g| > 1e-2 max|g| and
2 lr elsewhere: those of tests/test_torch_stylize.py:9-31. The phase-B
gradients, per leaf against its max|g|, are held wider than the fast
sampler's, because the up-sampler's CDF inversion moves a sample by up to
10^4 x an SDF difference where the CDF is flat, and the sample's trilinear
weights and the opacity term (1e5 x reg_scale) carry that into the
gradients:
* f32 tables: 5e-4 (the fast sampler's 1e-4; measured up to 2.7e-4, on the
  hash table). The JAX package's own gradients move by up to 2.1e-4 x
  max|g| when its parameters move by one ulp (the hash table; 1.1e-4 on
  the pyramid's first SDF layer; tests/parity_sensitivity.py);
* bf16 tables: 2e-2 for the MLP and variance leaves (measured 1.2e-2 on a
  composed fine step) and 2e-1 for the table leaves (measured 8.6e-2),
  4e-1 for a fine step's 16 patches (measured 2.6e-1). The JAX package's
  own jit and eager phase-B gradients of the same step differ by up to
  1.6e-1 (tables) and 1.3e-1 (MLP leaves) x max|g|: each patch's table
  cotangent is rounded to bf16, and other summation orders round it to the
  other neighbour. Bounds this wide would also pass a port that rendered
  with f32 tables, so each bf16 case also holds the MLP and variance
  gradients, as one vector, ten times closer (relative L2) to JAX's bf16
  gradients than to JAX's f32 ones on the same step (measured 1e-4 to
  5.3e-4 against 4e-2 to 1.1e-1; BF16_CONTROL).
The multi-prompt phase B against the single-prompt trainer: bitwise.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.models import diffusion as jdiff
from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.models import toy_guidance as jtoy
from avatarcraft_tpu.utils import background as jbg
from avatarcraft_tpu.workloads import multi_stylize as jms
from avatarcraft_tpu.workloads import stylize as jsty
from avatarcraft_tpu_torch.cli import stylize_cli
from avatarcraft_tpu_torch.models import diffusion, sd, toy_guidance
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.utils import background
from avatarcraft_tpu_torch.utils.checkpoint import leaves, load_params_with_config, map_leaves, save_params_with_config
from avatarcraft_tpu_torch.utils.metrics import integerify_img
from avatarcraft_tpu_torch.workloads import multi_stylize as ms
from avatarcraft_tpu_torch.workloads import stylize
from test_torch_render_parity import HASH_FCFG, HASH_JAX_FCFG
from test_torch_render_parity import hash_field as _hash_field
from tests.test_torch_stylize import (
    FIELD_ATOL,
    JAX_FCFG,
    JAX_TINY,
    RENDER_ATOL,
    SDS_ATOL,
    TINY,
    _field,
    _grad_store,
    _port,
    _port_fcfg,
    _scene,
    _t,
)

JAX_RCFG = jnsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=3, perturb=False)
RCFG = nsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=3, perturb=False)
# per leaf against its max|g|: (MLP and variance, tables); the f32 bound of
# the parity gradients (module docstring)
PARITY_GRAD_REL = {"float32": (5e-4, 5e-4), "bfloat16": (2e-2, 2e-1)}
PARITY_BF16_FINE_TABLE_REL = 4e-1
# the bf16 cases' control: the port's bf16 MLP and variance gradients at
# most this share of their relative L2 distance from JAX's f32 ones away
# from JAX's bf16 ones (module docstring)
BF16_CONTROL = 0.1
TABLE_LEAVES = ("['grids']", "['planes']", "['table']")
PROMPTS = ["lava", "emerald"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: tier-1 runs six
    pytest workers on the machine's cores. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy():
    """The TINY toy guidance (JAX init, jitted) as JAX's and the port's
    SDSGuidance modules, and the style embeddings."""
    jparams = jax.jit(lambda k: jtoy.init_toy_params(k, JAX_TINY))(jax.random.PRNGKey(2))
    embs = np.asarray(jtoy.style_embeddings(JAX_TINY))
    port = sd.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jparams, port, embs


def _guides(toy):
    jparams, port, embs = toy
    return (jdiff.SDSGuidance(jtoy.make_toy_modules(jparams, JAX_TINY)),
            diffusion.SDSGuidance(toy_guidance.make_toy_modules(port, TINY, _t(embs))))


def _assert_grads(got: dict, want, packed_dtype: str, rel_table: float | None = None):
    """Per leaf against its max|g| at PARITY_GRAD_REL: ``got`` the port's
    tree, ``want`` JAX's."""
    rel_mlp, table = PARITY_GRAD_REL[packed_dtype]
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


def _mlp_rel_l2(got: dict, want) -> float:
    """The relative L2 distance of the port's gradient tree ``got`` from
    JAX's ``want`` over their MLP and variance leaves as one vector."""
    num = den = 0.0
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree_util.tree_leaves(want)):
        if not jax.tree_util.keystr(path).startswith(TABLE_LEAVES):
            w = np.asarray(w, np.float64)
            num += float(((np.asarray(g, np.float64) - w) ** 2).sum())
            den += float((w**2).sum())
    return float(np.sqrt(num / den))


def _assert_bf16_control(got: dict, want_bf16, want_f32):
    """The port's bf16 gradients (MLP and variance leaves) lie closer to
    JAX's bf16 gradients than to JAX's f32 ones, by BF16_CONTROL."""
    to_bf16, to_f32 = _mlp_rel_l2(got, want_bf16), _mlp_rel_l2(got, want_f32)
    assert to_bf16 <= BF16_CONTROL * to_f32, (to_bf16, to_f32)


def _fields(encoder, packed_dtype="float32"):
    """(jax FieldConfig, port FieldConfig, jparams, jgt): the pyramid fields
    of tests/test_torch_stylize.py or the hash-grid fields of
    tests/test_torch_render_parity.py."""
    if encoder == "hashgrid":
        return HASH_JAX_FCFG, HASH_FCFG, _hash_field(0)[0], _hash_field(1)[0]
    jcfg = dataclasses.replace(JAX_FCFG, packed_dtype=packed_dtype)
    return jcfg, _port_fcfg(jcfg), _field(0), _field(1, bias=-0.8)


# ---------------------------------------------------------------------------
# phase A, phase B
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed_dtype,atol", [("float32", FIELD_ATOL), ("bfloat16", RENDER_ATOL)])
def test_phaseA_render_matches_jax(rng, packed_dtype, atol):
    jcfg, fcfg, jparams, _ = _fields("tpu_pyramid", packed_dtype)
    _, o, d = _scene(rng, 64)
    bg = rng.random((64, 3)).astype(np.float32)
    want = jsty.make_phaseA_render(jcfg, JAX_RCFG, 16)(jparams, o, d, bg, jax.random.PRNGKey(0))
    got = stylize.make_phaseA_render(fcfg, RCFG, 16)(_port(jparams), _t(o), _t(d), _t(bg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)


def _port_phaseB_grads(params, fcfg, gt_params, o, d, g_rgb, bg, chunk, use_opacity, rcfg=RCFG, generator=None):
    """The port's parity phase B of one step as the trainer runs it: the
    tables (a hash grid's table among them) packed in f32 once, the patches
    backpropagate into detached copies, one backward through the packing.
    Returns the gradient tree."""
    params = map_leaves(params, lambda t: t.clone().requires_grad_())
    packed32 = nsr.materialize_field_tables(params, dataclasses.replace(fcfg, packed_dtype="float32"))
    if "table" in params:
        packed32 = {**packed32, "table": params["table"]}
    tables = map_leaves(packed32, lambda t: t.detach().requires_grad_())
    gt = (gt_params, nsr.network_field_fns(gt_params, fcfg, rcfg.bound))
    step = stylize.make_phaseB_step(fcfg, rcfg, 0.01, use_opacity, chunk, 1e5, generator)
    loss = step(params, tables, gt, _t(o), _t(d), _t(g_rgb), _t(bg))
    torch.autograd.backward(leaves(packed32), [t.grad for t in leaves(tables)])
    return loss, map_leaves(params, lambda t: t.grad.numpy())


@pytest.mark.parametrize("encoder,packed_dtype,use_opacity", [
    ("tpu_pyramid", "float32", True), ("tpu_pyramid", "bfloat16", True), ("tpu_pyramid", "float32", False),
    ("hashgrid", "float32", True),
])
def test_phaseB_step_matches_jax(rng, encoder, packed_dtype, use_opacity):
    """One parity phase-B step over 4 patches of 32 rays against the JAX
    package's make_phaseB_step (its patch gradients summed)."""
    jcfg, fcfg, jparams, jgt = _fields(encoder, packed_dtype)
    _, o, d = _scene(rng, 128)
    g_rgb = rng.normal(size=(128, 3)).astype(np.float32) * 0.1
    bg = rng.random((128, 3)).astype(np.float32)
    tx = _grad_store()
    step = jsty.make_phaseB_step(jcfg, JAX_RCFG, tx, 0.01, use_opacity, 32, 1e5)
    _, want = step(jparams, jgt, tx.init(jparams), o, d, g_rgb, bg, jax.random.PRNGKey(0))
    _, got = _port_phaseB_grads(_port(jparams), fcfg, _port(jgt), o, d, g_rgb, bg, 32, use_opacity)
    _assert_grads(got, want, packed_dtype)
    if packed_dtype == "bfloat16":
        step32 = jsty.make_phaseB_step(_fields(encoder)[0], JAX_RCFG, tx, 0.01, use_opacity, 32, 1e5)
        _, want32 = step32(jparams, jgt, tx.init(jparams), o, d, g_rgb, bg, jax.random.PRNGKey(0))
        _assert_bf16_control(got, want, want32)


def test_gt_render_shares_the_patch_jitter(monkeypatch, rng):
    """With jitter on, each patch draws one [chunk, num_steps] U(0, 1) from
    the generator, and its styled render and its ground-truth render both
    take that draw (JAX passes one key to both); the next patch draws anew."""
    fcfg = _port_fcfg(JAX_FCFG)
    params, gt = _port(_field(0)), _port(_field(1, bias=-0.8))
    rcfg = dataclasses.replace(RCFG, perturb=True)
    calls = []
    real = stylize.render_rays

    def recording(*args, jitter=None, **kw):
        calls.append(jitter)
        return real(*args, jitter=jitter, **kw)

    monkeypatch.setattr(stylize, "render_rays", recording)
    _, o, d = _scene(rng, 64)
    g_rgb = rng.normal(size=(64, 3)).astype(np.float32) * 0.1
    bg = rng.random((64, 3)).astype(np.float32)
    _port_phaseB_grads(params, fcfg, gt, o, d, g_rgb, bg, 32, True, rcfg, torch.Generator().manual_seed(5))
    assert len(calls) == 4
    assert calls[0] is calls[1] and calls[2] is calls[3]
    gen = torch.Generator().manual_seed(5)
    for c in (calls[0], calls[2]):
        assert torch.equal(c, torch.rand((32, 6), generator=gen))
    assert not torch.equal(calls[0], calls[2])


# ---------------------------------------------------------------------------
# one composed SDS step
# ---------------------------------------------------------------------------


def _fixed_noise(select, to_array, bg_noise):
    def pick(n, key_id, *args, **kw):
        if key_id % 4 == 2:
            return to_array(bg_noise[:n])
        return select(n, key_id, *args, **kw)
    return pick


def _small_render_jax(jtr):
    """The test-only override of a JAX trainer's rcfg (JAX_RCFG) and the
    phases built from it."""
    c = jtr.cfg
    jtr.rcfg = JAX_RCFG
    jtr._phaseA = {}
    if isinstance(jtr, jsty.StylizeTrainer):
        jtr._phaseB = jsty.make_phaseB_step(jtr.fcfg, JAX_RCFG, jtr.tx, c.w_eikonal, c.use_opacity, c.batch_size,
                                            c.w_opacity)


def _small_render(jtr, tr):
    """The test-only override of both trainers' rcfg (JAX_RCFG / RCFG) and
    the phases built from it."""
    _small_render_jax(jtr)
    tr.rcfg = RCFG
    tr._phaseA = {}
    tr._phaseB = tr._make_phaseB()


def _check_adam_step(jparams, params, mu):
    """Adam's first update is lr x sign(g) where |g| >> eps."""
    gl = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jparams))
    pl = jax.tree_util.tree_leaves(map_leaves(params, lambda t: t.numpy()))
    for w, g, m in zip(gl, pl, jax.tree_util.tree_leaves(mu)):
        m = np.asarray(m)
        big = np.abs(m) > 1e-2 * np.abs(m).max()
        np.testing.assert_allclose(g[big], w[big], atol=1e-6, rtol=0)
        np.testing.assert_allclose(g, w, atol=2 * 5e-3, rtol=0)


@pytest.mark.parametrize("packed_dtype,epoch,rel_table", [
    ("float32", 0, None), ("float32", 1, None), ("bfloat16", 1, PARITY_BF16_FINE_TABLE_REL),
])
def test_train_view_matches_jax(monkeypatch, toy, packed_dtype, epoch, rel_table):
    """One parity train_view: coarse (an 8x8 frame, one patch) or fine
    (32x32, 16 patches), f32 tables, and a fine one with bf16 tables (also
    against a JAX trainer with f32 tables on the same step: the bf16
    control); t, the SDS noise and the noise backgrounds injected into all."""
    rng = np.random.default_rng(11)
    jcfg, fcfg, jparams, jgt = _fields("tpu_pyramid", packed_dtype)
    jguide, guide = _guides(toy)
    cfg = dict(tgt_text="lava", H=32, W=32, batch_size=64, n_cap=8, lr=5e-3, coarse_epochs=1, fine_epochs=1)
    jtr = jsty.StylizeTrainer(jsty.StylizeConfig(**cfg), jcfg, jguide, jparams, jgt)
    tr = stylize.StylizeTrainer(stylize.StylizeConfig(**cfg), fcfg, guide, _port(jparams), _port(jgt))
    assert tr.cfg.sampler == "parity" and tr.grid is None and tr.fast_cfg is None
    assert tr.rcfg == nsr.RenderConfig(num_steps=64, upsample_steps=64, bound=1.6, perturb=True, normal_mode="fd7")
    _small_render(jtr, tr)
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

    monkeypatch.setattr(jguide, "sds_image_grad_jit", jsds)
    monkeypatch.setattr(guide, "sds_image_grad", sds)
    monkeypatch.setattr(jsty, "select_background", _fixed_noise(jbg.select_background, jnp.asarray, bg_noise))
    monkeypatch.setattr(stylize, "select_background", _fixed_noise(background.select_background, _t, bg_noise))

    for trainer in (jtr, tr):
        poses, descs = trainer.epoch_poses(epoch)
        i = int(trainer.rng.permutation(len(poses))[0])
        trainer.train_view(poses[i], descs[i], epoch)
    assert jtr.rng.bit_generator.state == tr.rng.bit_generator.state
    np.testing.assert_allclose(seen["port"].numpy(), np.asarray(seen["jax"]), atol=SDS_ATOL, rtol=0)
    assert np.abs(np.asarray(seen["jax"])).max() > 1e-3

    mu = jtr.opt_state[0].mu
    moments = map_leaves(tr.rest, lambda t: tr.opt.state[t]["exp_avg"])
    table = torch.cat([tr.opt.state[s]["exp_avg"] for s in tr.shards])
    got = map_leaves(tr.splice(moments, table), lambda t: t.numpy())
    _assert_grads(got, mu, packed_dtype, rel_table)
    _check_adam_step(jtr.params_style, tr.params(), mu)
    assert tr.stats == {"refreshes": 0, "clip_guard_trips": 0}
    if packed_dtype == "bfloat16":
        jtr32 = jsty.StylizeTrainer(jsty.StylizeConfig(**cfg), _fields("tpu_pyramid")[0], jguide, jparams, jgt)
        _small_render_jax(jtr32)
        poses, descs = jtr32.epoch_poses(epoch)
        i = int(jtr32.rng.permutation(len(poses))[0])
        jtr32.train_view(poses[i], descs[i], epoch)
        _assert_bf16_control(got, mu, jtr32.opt_state[0].mu)


def _moments(tr, p):
    """Prompt p's Adam first moments as a tree of numpy arrays."""
    rest, shards, splice = tr.fields[p]
    m = map_leaves(rest, lambda t: tr.opt.state[t]["exp_avg"])
    return map_leaves(splice(m, torch.cat([tr.opt.state[s]["exp_avg"] for s in shards])), lambda t: t.numpy())


def test_multi_train_view_matches_jax(monkeypatch, toy):
    """One fine parity train_view of MultiPromptTrainer at P = 2 (f32
    tables, 16 patches per prompt); t, the noise and the noise backgrounds
    injected."""
    epoch = 1
    rng = np.random.default_rng(11)
    jcfg, fcfg, jparams, jgt = _fields("tpu_pyramid")
    jguide, guide = _guides(toy)
    cfg = dict(H=32, W=32, batch_size=64, n_cap=8, lr=5e-3, coarse_epochs=1, fine_epochs=1)
    jps = [jparams, _field(2)]
    jtr = jms.MultiPromptTrainer(jsty.StylizeConfig(**cfg), jcfg, jguide, list(PROMPTS), jms.stack_params(jps), jgt)
    tr = ms.MultiPromptTrainer(stylize.StylizeConfig(**cfg), fcfg, guide, list(PROMPTS),
                               ms.stack_params([_port(p) for p in jps]), _port(jgt))
    assert tr.grids is None and tr.fast_cfg is None
    _small_render(jtr, tr)
    t_inj = np.asarray([617, 233])
    noise = rng.normal(size=(2, 3, 16, 16)).astype(np.float32)
    bg_noise = rng.random((32 * 32, 3)).astype(np.float32)
    style_rows = jnp.asarray(toy[2][[toy_guidance.style_index(p) for p in PROMPTS]])
    seen = {"jax": {}}
    real_jsds = jguide.sds_image_grad

    def jsds(key, emb, img, gs, pred_depth=None):
        # under jax.vmap: the prompt is the style whose embedding is emb's cond row
        p = jnp.argmin(jnp.abs(style_rows - emb[1]).sum(axis=(1, 2)))
        g = real_jsds(key, emb, img, gs, t_override=jnp.asarray(t_inj)[p], noise_override=jnp.asarray(noise)[p][None])
        jax.debug.callback(lambda i, v: seen["jax"].__setitem__(int(i), np.asarray(v)), p, g)
        return g

    def sds(emb, img, gs, pred_depth=None, **kw):
        seen["port"] = diffusion.SDSGuidance.sds_image_grad_batch(guide, emb, img, gs, t_override=t_inj,
                                                                   noise_override=_t(noise))
        return seen["port"]

    monkeypatch.setattr(jguide, "sds_image_grad", jsds)
    monkeypatch.setattr(guide, "sds_image_grad_batch", sds)
    monkeypatch.setattr(jbg, "select_background", _fixed_noise(jbg.select_background, jnp.asarray, bg_noise))
    monkeypatch.setattr(ms, "select_background", _fixed_noise(background.select_background, _t, bg_noise))
    for trainer in (jtr, tr):
        poses, descs = stylize.epoch_poses(trainer.cfg, trainer.rng, epoch)
        i = int(trainer.rng.permutation(len(poses))[0])
        trainer.train_view(poses[i], descs[i], epoch)
    jax.effects_barrier()
    assert jtr.rng.bit_generator.state == tr.rng.bit_generator.state
    want_g = np.stack([seen["jax"][p][0] for p in range(2)])
    np.testing.assert_allclose(seen["port"].numpy(), want_g, atol=SDS_ATOL, rtol=0)

    mus = jms.unstack_params(jtr.opt_state[0].mu, 2)
    jfields = jms.unstack_params(jtr.params_style, 2)
    for p, params in enumerate(tr.params_list()):
        _assert_grads(_moments(tr, p), mus[p], "float32")
        _check_adam_step(jfields[p], params, mus[p])


def test_multi_phaseB_matches_single_prompt_trainer(monkeypatch, toy):
    """Each prompt's parity phase B in a multi step is bitwise a
    single-prompt parity StylizeTrainer's on the same view, SDS gradient
    and jitter (draw_jitter fixed, so that the generator's order across
    prompts does not enter), at w_eikonal 0.3 and w_opacity 7."""
    _, guide = _guides(toy)
    fcfg = _port_fcfg(JAX_FCFG)
    cfg = stylize.StylizeConfig(H=32, W=32, batch_size=64, n_cap=8, coarse_epochs=0, fine_epochs=1,
                                w_eikonal=0.3, w_opacity=7.0, augment_bkg=False)
    ps, gt = [_port(_field(0)), _port(_field(2))], _port(_field(1, bias=-0.8))
    g = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, 32, 32)).astype(np.float32) * 0.1)
    small = dataclasses.replace(RCFG, perturb=True)
    monkeypatch.setattr(stylize, "draw_jitter",
                        lambda n, rcfg, gen, dev: torch.rand((n, rcfg.num_steps), generator=torch.Generator().manual_seed(n)))
    multi = ms.MultiPromptTrainer(cfg, fcfg, guide, PROMPTS, ms.stack_params(ps), gt)
    multi.rcfg = small
    multi._phaseA, multi._phaseB = {}, multi._make_phaseB()
    multi.guidance = diffusion.SDSGuidance(guide.m)
    multi.guidance.sds_image_grad_batch = lambda emb, img, gs, **kw: g
    poses, descs = multi.epoch_poses(0)
    i = int(multi.rng.permutation(len(poses))[0])
    losses = multi.train_view(poses[i], descs[i], 0)
    for p in range(2):
        single = stylize.StylizeTrainer(cfg, fcfg, diffusion.SDSGuidance(guide.m), ps[p], gt)
        single.rcfg = small
        single._phaseA, single._phaseB = {}, single._make_phaseB()
        single.guidance.sds_image_grad = lambda emb, img, gs, p=p, **kw: g[p : p + 1]
        sposes, sdescs = single.epoch_poses(0)
        assert int(single.rng.permutation(len(sposes))[0]) == i
        assert torch.equal(single.train_view(sposes[i], sdescs[i], 0), losses[p])
        want = map_leaves(single.rest, lambda t: single.opt.state[t]["exp_avg"])
        want = single.splice(want, torch.cat([single.opt.state[s]["exp_avg"] for s in single.shards]))
        for a, b in zip(leaves(_moments(multi, p)), leaves(want)):
            np.testing.assert_array_equal(a, b.numpy())


# ---------------------------------------------------------------------------
# the CLI at its default sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("encoder,extra", [
    ("tpu_pyramid", []), ("hashgrid", ["--encoder", "hashgrid"]), ("hashgrid", ["--sampler", "fast"]),
])
def test_cli_defaults_on_cpu(tmp_path, monkeypatch, encoder, extra):
    """The CLI at its defaults (the parity sampler; the fast one where
    asked) on a small pyramid or hash-grid checkpoint, the frame cut from
    256x256 to 32x32 (the CPU's cost; patched into the CLI's config) and
    64-ray patches: two SDS steps, the validation PNG at step 2, which is
    the parity render of the final field (render_rays_chunked, 64+64, no
    jitter, white, fd7), a mesh at 16^3, and the final checkpoint, which
    loads as the trainer's parameters."""
    real = stylize_cli.stylize_config
    monkeypatch.setattr(stylize_cli, "stylize_config", lambda opt: dataclasses.replace(real(opt), H=32, W=32))
    monkeypatch.setattr(stylize_cli, "MESH_RESOLUTION", 16)
    if encoder == "hashgrid":
        params, fcfg = _port(_hash_field(0)[0]), HASH_FCFG
    else:
        params, fcfg = _port(_field(0)), _port_fcfg(JAX_FCFG)
    ckpt = str(tmp_path / "field.pth.tar")
    save_params_with_config(params, ckpt, fcfg)
    grid = str(tmp_path / "grid.npy")
    np.save(grid, np.where(np.random.default_rng(0).random((17, 17, 17)) < 0.4, 50.0, 0.5).astype(np.float32))
    trainer = stylize_cli.main(["--weights_path", ckpt, "--use_cuda", "false", "--out_dir", str(tmp_path / "out"),
                                "--exp_name", "t", "--batch_size", "64", "--max_steps", "2", "--i_val", "2",
                                "--i_mesh", "2", "--grid_path", grid, "--sample_budget", "0"] + extra)
    fast = "fast" in extra
    assert trainer.cfg.sampler == ("fast" if fast else "parity") and trainer.fast == fast
    exp = tmp_path / "out" / "t"
    assert sorted(os.listdir(exp)) == ["t_0002.ply", "t_0002_body.png", "t_args.txt", "t_final.pth.tar",
                                       "t_final.pth.tar.fieldcfg.json"]
    loaded, lcfg = load_params_with_config(str(exp / "t_final.pth.tar"), device="cpu")
    assert lcfg.encoder == encoder
    final = trainer.params()
    assert all(torch.equal(a, b) for a, b in zip(leaves(loaded), leaves(final)))
    assert not torch.equal(loaded["sdf"][0]["v"], params["sdf"][0]["v"])  # the style moved
    if encoder == "hashgrid":
        assert not torch.equal(loaded["table"], params["table"])
    from test_torch_guards import _read_png

    img = _read_png(str(exp / "t_0002_body.png"))
    assert img.shape == (32, 32, 3)
    if not fast:
        poses, _ = stylize_cli.default_360_path(np.zeros(3), np.array([0.0, 1.0, 0.0]),
                                                stylize_cli.CANONICAL_CAMERA_DIST_VAL, trainer.cfg.n_cap)
        ro, rd = stylize_cli.pose2rays(32, 32, poses[0], device="cpu")
        with torch.no_grad():
            rgb = nsr.render_rays_chunked(final, ro, rd, lcfg, nsr.RenderConfig(bound=1.6), 1.0, chunk=64)["rgb"]
        np.testing.assert_array_equal(img, integerify_img(rgb.reshape(32, 32, 3).numpy()))
