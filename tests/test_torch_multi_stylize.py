"""The port's multi-prompt stylization against the JAX package, on the CPU
(the JAX side under ``jax.jit`` where it jits), at small widths: the
stacked trees, the derived budget, the clip guard, one composed
``train_view`` at P = 2, phase B against the single-prompt trainer, the
guidance batched over prompts, and the tool twin end to end.

Tolerances:
* ``stack_params`` / ``unstack_params``, the derived budget, the step the
  clip guard trips at, the schedule's generator state: exact;
* the composed ``train_view`` (t, the SDS noise and the noise backgrounds
  injected into both): the bounds of tests/test_torch_stylize.py:9-31 --
  each prompt's SDS image gradient 4.02e-3 absolute, its gradients per leaf
  against max|g| (f32 tables 1e-4; bf16 tables 2e-3 for the MLP and
  variance leaves, 1e-1 for the table leaves), the Adam step 1e-6 where
  |g| > 1e-2 max|g| and 2 lr elsewhere; each prompt's refreshed and pruned
  grid within 512^2/4 x 1e-6 of JAX's vmapped refresh and pruning of the
  port's updated field (JAX's own field differs by up to 2 lr where a
  gradient is near 0, and the density 512 sigmoid(-512 sdf) turns that
  into whole cells);
* phase B of each prompt against the port's single-prompt trainer on the
  same view and SDS gradient: bitwise (the same code on the same inputs);
* the guidance batched over P prompts against P single calls: 1e-5 x the
  largest |g| (one UNet call of 2P samples against P calls of 2);
* the tool's checkpoints: loaded by the JAX package's
  ``load_params_with_config`` bitwise equal to the trainer's parameters.

JAX draws SDS's t and noise from jax.random, the port from a torch
generator: the composed step injects them into both.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.models import diffusion as jdiff
from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.models import toy_guidance as jtoy
from avatarcraft_tpu.ops import occupancy as jocc
from avatarcraft_tpu.utils import background as jbg
from avatarcraft_tpu.utils.checkpoint import load_params_with_config as jax_load_params_with_config
from avatarcraft_tpu.workloads import multi_stylize as jms
from avatarcraft_tpu.workloads import reconstruct as jrecon
from avatarcraft_tpu.workloads import stylize as jsty
from avatarcraft_tpu_torch.models import diffusion, sd, toy_guidance
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.tools import run_multi_stylize
from avatarcraft_tpu_torch.utils import background
from avatarcraft_tpu_torch.utils.checkpoint import leaves, map_leaves, save_params_with_config
from avatarcraft_tpu_torch.workloads import multi_stylize as ms
from avatarcraft_tpu_torch.workloads import stylize
from tests.test_torch_stylize import (
    BF16_FINE_TABLE_REL,
    GRID_ATOL,
    JAX_FCFG,
    JAX_TINY,
    SDS_ATOL,
    TINY,
    _assert_grads,
    _field,
    _port,
    _port_fcfg,
    _t,
)

PROMPTS = ["lava", "emerald"]
BATCH_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: tier-1 runs six
    pytest workers on the machine's cores, and workers whose torch ops each
    spread over every core oversubscribe it. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _jfield(seed=0, bias=-1.0):
    """tests/test_torch_stylize.py's small field, drawn once per module
    (JAX's eager init compiles op by op)."""
    return _field(seed, bias)


def _grid(seed=9, R=17):
    return np.where(np.random.default_rng(seed).random((R, R, R)) < 0.6, 50.0, 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def toy():
    """The TINY toy guidance (JAX init, jitted), as JAX's and the port's
    SDSGuidance, and the style embeddings."""
    jparams = jax.jit(lambda k: jtoy.init_toy_params(k, JAX_TINY))(jax.random.PRNGKey(2))
    embs = np.asarray(jtoy.style_embeddings(JAX_TINY))
    port = sd.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jparams, port, embs


def _guides(toy):
    jparams, port, embs = toy
    return (jdiff.SDSGuidance(jtoy.make_toy_modules(jparams, JAX_TINY)),
            diffusion.SDSGuidance(toy_guidance.make_toy_modules(port, TINY, _t(embs))))


def _jax_trainer(monkeypatch, cfg, jcfg, jguide, jparams_list, jgt, jfast, grids):
    """JAX's MultiPromptTrainer with ``grids`` in place of its setup
    refresh at 129^3 (skipped: the refresh is held at the grids' size)."""
    real = jrecon.make_grid_update_fn

    def skip_setup_refresh(fcfg, bound):
        refresh = real(fcfg, bound)
        return lambda p, g: g if g.shape[0] == 129 else refresh(p, g)

    with monkeypatch.context() as m:
        m.setattr(jrecon, "make_grid_update_fn", skip_setup_refresh)
        tr = jms.MultiPromptTrainer(cfg, jcfg, jguide, list(PROMPTS), jms.stack_params(jparams_list), jgt,
                                    fast_cfg=jfast)
    tr._refresh_grid = jax.vmap(real(jcfg, 1.6))
    tr.grids = jnp.asarray(grids)
    return tr


def _trainers(monkeypatch, toy, packed_dtype, cfg_kw, budget=0):
    """A JAX and a port MultiPromptTrainer whose two prompts start, as the
    tool's do, from one small field and one small grid; the TINY toy
    guidance. (Other fields and grids per prompt are held, port against
    port, in test_phaseB_matches_single_prompt_trainer.)"""
    jcfg = dataclasses.replace(JAX_FCFG, packed_dtype=packed_dtype)
    jps, jgt = [_jfield(0), _jfield(0)], _jfield(1, bias=-0.8)
    grids = np.stack([_grid(9), _grid(9)])
    jguide, guide = _guides(toy)
    cfg = dict(H=32, W=32, batch_size=64, n_cap=8, lr=5e-3, sampler="fast", **cfg_kw)
    jfast = jnsr.FastRenderConfig(n_probes=32, k_samples=8, sample_budget=budget)
    jtr = _jax_trainer(monkeypatch, jsty.StylizeConfig(**cfg), jcfg, jguide, jps, jgt, jfast, grids)
    tr = ms.MultiPromptTrainer(stylize.StylizeConfig(**cfg), _port_fcfg(jcfg), guide, list(PROMPTS),
                               ms.stack_params([_port(p) for p in jps]), _port(jgt), grids=_t(grids),
                               fast_cfg=nsr.FastRenderConfig(n_probes=32, k_samples=8, sample_budget=budget))
    return jtr, tr, jguide, guide


def _moments(tr, p):
    """Prompt p's Adam first moments as a tree of numpy arrays."""
    rest, shards, splice = tr.fields[p]
    m = map_leaves(rest, lambda t: tr.opt.state[t]["exp_avg"])
    return map_leaves(splice(m, torch.cat([tr.opt.state[s]["exp_avg"] for s in shards])), lambda t: t.numpy())


# ---------------------------------------------------------------------------
# stacked trees, budget, clip guard
# ---------------------------------------------------------------------------


def test_stack_unstack_matches_jax():
    jps = [_jfield(i) for i in range(3)]
    got = ms.stack_params([_port(p) for p in jps])
    want = jms.stack_params(jps)
    assert got["variance"].shape == (3,)
    gl, wl = jax.tree_util.tree_flatten_with_path(map_leaves(got, lambda t: t.numpy()))[0], \
        jax.tree_util.tree_flatten_with_path(want)[0]
    assert [jax.tree_util.keystr(k) for k, _ in gl] == [jax.tree_util.keystr(k) for k, _ in wl]
    for (_, g), (_, w) in zip(gl, wl):
        np.testing.assert_array_equal(g, np.asarray(w))
    for back, jback in zip(ms.unstack_params(got, 3), jms.unstack_params(want, 3)):
        for a, b in zip(jax.tree_util.tree_leaves(map_leaves(back, lambda t: t.numpy())),
                        jax.tree_util.tree_leaves(jback)):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("cfg_kw", [dict(), dict(subsample_scale=2, augment_cam=False, stylize_head=False)])
def test_derive_budget_matches_jax(monkeypatch, toy, cfg_kw):
    """The same integer as JAX's on the same grids. derive_budget draws its
    poses' jitter at noise_scale 1.0, the JAX package's choice
    (multi_stylize.py:128-132; its train draws at 2.0, :289): the port
    keeps it."""
    jtr, tr, _, _ = _trainers(monkeypatch, toy, "float32", cfg_kw)
    calls = []
    real = ms.style_360_path

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(ms, "style_360_path", spy)
    monkeypatch.setattr(stylize, "style_360_path", spy)
    got = tr.derive_budget(n_poses=6)
    assert got == jtr.derive_budget(n_poses=6) == tr.fast_cfg.sample_budget == jtr.fast_cfg.sample_budget
    assert got > 0
    assert "noise_scale" not in calls[0] and calls[0]["add_noise"] == tr.cfg.augment_cam
    tr.epoch_poses(0)
    assert calls[1]["noise_scale"] == (2.0 if tr.cfg.augment_cam else 1.0)


def test_clip_guard_trips_on_the_same_step_as_jax(monkeypatch, toy):
    """The derived budget holds through a refresh; a starved one turns
    compaction off at the next refresh, on both."""
    jtr, tr, _, _ = _trainers(monkeypatch, toy, "float32", dict(coarse_epochs=1, fine_epochs=0,
                                                                grid_update_every=1))
    assert tr.derive_budget(n_poses=3) == jtr.derive_budget(n_poses=3)
    budgets = {"jax": [], "port": []}
    assert jtr.train(max_steps=1, on_step=lambda s, p: budgets["jax"].append(jtr.fast_cfg.sample_budget)) == 1
    assert tr.train(max_steps=1, on_step=lambda s, t: budgets["port"].append(t.fast_cfg.sample_budget)) == 1
    tr.set_budget(3)
    jtr.fast_cfg = dataclasses.replace(jtr.fast_cfg, sample_budget=3)
    jtr._phaseA = {}
    if hasattr(jtr, "_count_jit"):
        del jtr._count_jit
    jtr.train(max_steps=1, on_step=lambda s, p: budgets["jax"].append(jtr.fast_cfg.sample_budget))
    tr.train(max_steps=1, on_step=lambda s, t: budgets["port"].append(t.fast_cfg.sample_budget))
    assert budgets["port"] == budgets["jax"] and budgets["port"][0] > 3 and budgets["port"][1:] == [0]
    assert tr.stats == {"refreshes": 2, "clip_guard_trips": 1}
    assert jtr.rng.bit_generator.state == tr.rng.bit_generator.state


def test_text_embeddings_cached_per_view(toy):
    _, guide = _guides(toy)
    tr = ms.MultiPromptTrainer(stylize.StylizeConfig(sampler="fast"), _port_fcfg(JAX_FCFG), guide, PROMPTS,
                               ms.stack_params([_port(_jfield(0))] * 2), _port(_jfield(1)),
                               grids=_t(np.stack([_grid()] * 2)))
    e = tr.text_embeddings("front view")
    assert e.shape == (2, 2, TINY.seq_len, TINY.emb_dim) and tr.text_embeddings("front view") is e
    for p, prompt in enumerate(PROMPTS):
        assert torch.equal(e[p], guide.get_text_embeds([f"front view {prompt}"]))
    assert torch.equal(tr.text_embs[1], guide.get_text_embeds(["emerald"]))


# ---------------------------------------------------------------------------
# one composed multi-prompt step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed_dtype,epoch,rel_table", [
    ("float32", 0, None), ("float32", 1, None), ("bfloat16", 0, None), ("bfloat16", 1, BF16_FINE_TABLE_REL),
])
def test_train_view_matches_jax(monkeypatch, toy, packed_dtype, epoch, rel_table):
    """One train_view at P = 2: coarse (an 8x8 frame, one patch) or fine
    (32x32, 16 patches), then each prompt's grid refreshed and pruned and
    the clip guard; t, the noise and the noise backgrounds injected."""
    rng = np.random.default_rng(11)
    jtr, tr, jguide, guide = _trainers(monkeypatch, toy, packed_dtype,
                                       dict(coarse_epochs=1, fine_epochs=1, grid_update_every=1), budget=300)
    t_inj = np.asarray([617, 233])
    noise = rng.normal(size=(2, 3, 16, 16)).astype(np.float32)
    bg_noise = rng.random((32 * 32, 3)).astype(np.float32)
    style_rows = jnp.asarray(toy[2][[toy_guidance.style_index(p) for p in PROMPTS]])
    seen = {"jax": {}}
    real_jsds = jguide.sds_image_grad

    def jsds(key, emb, img, gs, pred_depth=None):
        # under jax.vmap: the prompt is the style whose embedding is emb's cond row
        p = jnp.argmin(jnp.abs(style_rows - emb[1]).sum(axis=(1, 2)))
        g = real_jsds(key, emb, img, gs, t_override=jnp.asarray(t_inj)[p],
                      noise_override=jnp.asarray(noise)[p][None])
        jax.debug.callback(lambda i, v: seen["jax"].__setitem__(int(i), np.asarray(v)), p, g)
        return g

    def sds(emb, img, gs, pred_depth=None, **kw):
        seen["port"] = diffusion.SDSGuidance.sds_image_grad_batch(guide, emb, img, gs, t_override=t_inj,
                                                                   noise_override=_t(noise))
        return seen["port"]

    def fixed_noise(select, to_array):
        def pick(n, key_id, *args, **kw):
            if key_id % 4 == 2:
                return to_array(bg_noise[:n])
            return select(n, key_id, *args, **kw)
        return pick

    monkeypatch.setattr(jguide, "sds_image_grad", jsds)
    monkeypatch.setattr(guide, "sds_image_grad_batch", sds)
    monkeypatch.setattr(jbg, "select_background", fixed_noise(jbg.select_background, jnp.asarray))
    monkeypatch.setattr(ms, "select_background", fixed_noise(background.select_background, _t))
    grids0 = tr.grids.numpy().copy()
    for trainer in (jtr, tr):
        # the JAX trainer's train draws its epochs as stylize.epoch_poses does
        poses, descs = stylize.epoch_poses(trainer.cfg, trainer.rng, epoch)
        i = int(trainer.rng.permutation(len(poses))[0])
        trainer.train_view(poses[i], descs[i], epoch)
    jax.effects_barrier()
    assert jtr.rng.bit_generator.state == tr.rng.bit_generator.state
    want_g = np.stack([seen["jax"][p][0] for p in range(2)])
    np.testing.assert_allclose(seen["port"].numpy(), want_g, atol=SDS_ATOL, rtol=0)
    assert np.abs(want_g).max() > 1e-3

    mus = jms.unstack_params(jtr.opt_state[0].mu, 2)
    jparams = jms.unstack_params(jtr.params_style, 2)
    for p, params in enumerate(tr.params_list()):
        _assert_grads(_moments(tr, p), mus[p], packed_dtype, rel_table)
        gl = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jparams[p]))
        pl = jax.tree_util.tree_leaves(map_leaves(params, lambda t: t.numpy()))
        for w, g, m in zip(gl, pl, jax.tree_util.tree_leaves(mus[p])):
            m = np.asarray(m)
            big = np.abs(m) > 1e-2 * np.abs(m).max()
            np.testing.assert_allclose(g[big], w[big], atol=1e-6, rtol=0)
            np.testing.assert_allclose(g, w, atol=2 * 5e-3, rtol=0)
    # the refresh and pruning at step 1, JAX's (vmapped) on the port's fields
    jfields = jms.stack_params([jax.tree_util.tree_map(jnp.asarray, map_leaves(p, lambda t: t.numpy()))
                                for p in tr.params_list()])
    want = jax.jit(jax.vmap(jocc.prune_grid_floaters))(jtr._refresh_grid(jfields, jnp.asarray(grids0)), grids0)
    np.testing.assert_allclose(tr.grids.numpy(), np.asarray(want), atol=GRID_ATOL, rtol=0)
    assert tr.fast_cfg.sample_budget == jtr.fast_cfg.sample_budget
    assert tr.stats["refreshes"] == 1


def test_phaseB_matches_single_prompt_trainer(toy):
    """Each prompt's gradients of a multi step equal a single-prompt
    StylizeTrainer's on the same view and SDS gradient, at w_eikonal 0.3
    and w_opacity 7 (the config's weights reach phase B) and 64-ray patches
    (reg_scale = 64/4096)."""
    _, guide = _guides(toy)
    fcfg = _port_fcfg(JAX_FCFG)
    cfg = stylize.StylizeConfig(H=32, W=32, batch_size=64, n_cap=8, coarse_epochs=0, fine_epochs=1,
                                w_eikonal=0.3, w_opacity=7.0, augment_bkg=False, grid_update_every=0,
                                sampler="fast")
    fast = nsr.FastRenderConfig(n_probes=32, k_samples=8)
    ps, gt = [_port(_jfield(0)), _port(_jfield(2))], _port(_jfield(1, bias=-0.8))
    grids = [_t(_grid(9)), _t(_grid(10))]
    g = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, 32, 32)).astype(np.float32) * 0.1)
    multi = ms.MultiPromptTrainer(cfg, fcfg, guide, PROMPTS, ms.stack_params(ps), gt, grids=torch.stack(grids),
                                  fast_cfg=fast)
    multi.guidance = diffusion.SDSGuidance(guide.m)
    multi.guidance.sds_image_grad_batch = lambda emb, img, gs, **kw: g
    poses, descs = multi.epoch_poses(0)
    i = int(multi.rng.permutation(len(poses))[0])
    losses = multi.train_view(poses[i], descs[i], 0)
    for p in range(2):
        single = stylize.StylizeTrainer(cfg, fcfg, diffusion.SDSGuidance(guide.m), ps[p], gt, grid=grids[p],
                                        fast_cfg=fast)
        single.guidance.sds_image_grad = lambda emb, img, gs, p=p, **kw: g[p : p + 1]
        sposes, sdescs = single.epoch_poses(0)
        assert int(single.rng.permutation(len(sposes))[0]) == i
        loss = single.train_view(sposes[i], sdescs[i], 0)
        assert torch.equal(loss, losses[p])
        want = map_leaves(single.rest, lambda t: single.opt.state[t]["exp_avg"])
        want = single.splice(want, torch.cat([single.opt.state[s]["exp_avg"] for s in single.shards]))
        got = _moments(multi, p)
        for a, b in zip(leaves(got), leaves(want)):
            np.testing.assert_array_equal(a, b.numpy())


# ---------------------------------------------------------------------------
# the guidance batched over prompts
# ---------------------------------------------------------------------------


def _depth_modules():
    """Stand-in modules with depth conditioning: the UNet reads the depth
    channel it is given."""
    base = diffusion.make_dummy_modules(image_size=16, device="cpu")

    def unet(lat, t, emb):
        return base.unet(lat[:, :-1], t, emb) + 0.3 * lat[:, -1:] * torch.cos(lat[:, :-1])

    return dataclasses.replace(base, unet=unet, use_depth=True)


@pytest.mark.parametrize("P,modules,injected", [(2, "toy", False), (3, "toy", True), (1, "toy", False),
                                                 (2, "depth", False)])
def test_batched_guidance_matches_single_calls(toy, P, modules, injected):
    """sds_image_grad_batch of P images against P sds_image_grad calls:
    with a generator, the batched call draws t_p then noise_p prompt by
    prompt, as the P calls draw them in turn; or t and noise injected."""
    if modules == "toy":
        _, guide = _guides(toy)
    else:
        guide = diffusion.SDSGuidance(_depth_modules())
    rng = np.random.default_rng(P)
    imgs = _t(rng.random((P, 3, 8, 8)).astype(np.float32))
    depth = _t(rng.random((P, 1, 8, 8)).astype(np.float32) * 3.0) if modules == "depth" else None
    prompts = ["lava", "emerald", "porcelain"][:P]
    embs = torch.stack([guide.get_text_embeds([f"side view {p}"]) for p in prompts])
    kw = {}
    if injected:
        kw = dict(t_override=[20 + 300 * p for p in range(P)],
                  noise_override=_t(rng.normal(size=(P, 3, 16, 16)).astype(np.float32)))
    got = guide.sds_image_grad_batch(embs, imgs, 100.0, pred_depth=depth, generator=torch.Generator().manual_seed(3),
                                     **kw)
    gen = torch.Generator().manual_seed(3)
    want = torch.cat([
        guide.sds_image_grad(embs[p], imgs[p : p + 1], 100.0,
                             pred_depth=None if depth is None else depth[p : p + 1], generator=gen,
                             **({} if not injected else dict(t_override=kw["t_override"][p],
                                                              noise_override=kw["noise_override"][p : p + 1])))
        for p in range(P)
    ])
    assert got.shape == imgs.shape
    scale = float(want.abs().max())
    assert scale > 1e-3
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=BATCH_REL * scale, rtol=0)
    with pytest.raises(ValueError, match="embeddings"):
        guide.sds_image_grad_batch(embs[:, :1], imgs, 100.0)


# ---------------------------------------------------------------------------
# the tool twin, end to end on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def tool_inputs(tmp_path, toy, monkeypatch):
    """A small field checkpoint, the TINY toy guidance written as the
    tool reads it, and the setup's 129^3 grid refreshes done on a 17^3
    lattice (the refresh itself is held in the tests above)."""
    _, port, embs = toy
    ckpt = str(tmp_path / "field.pth.tar")
    save_params_with_config(_port(_jfield(0)), ckpt, _port_fcfg(JAX_FCFG))
    toy_dir = str(tmp_path / "toy")
    toy_guidance.save_toy_guidance(toy_dir, port, TINY, _t(embs))
    real = ms.make_grid_update_fn

    def small_lattice(fcfg, bound):
        refresh = real(fcfg, bound)
        return lambda p, g: refresh(p, torch.zeros((17,) * 3) if g.shape[0] == 129 else g)

    monkeypatch.setattr(ms, "make_grid_update_fn", small_lattice)
    epochs = []
    real_view = ms.MultiPromptTrainer.train_view

    def recorded(self, pose, desc, epoch):
        epochs.append(epoch)
        return real_view(self, pose, desc, epoch)

    monkeypatch.setattr(ms.MultiPromptTrainer, "train_view", recorded)
    out = str(tmp_path / "multi")
    argv = ["--weights_path", ckpt, "--toy_weights", toy_dir, "--prompts", "lava,emerald", "--use_cuda", "false",
            "--hw", "16", "--batch_size", "16", "--n_cap", "4", "--out", out, "--log_every", "1"]
    return argv, out, epochs


def test_run_multi_stylize_end_to_end(tool_inputs, capsys):
    """--steps 2 --fine_steps 2 --n_cap 4 --i_save 2: the files, the final
    JSON line, 1-based on_step counts in the log, and checkpoints that the
    JAX package's loader reads as the trainer's parameters. The JAX tool's
    epoch round-up is kept: coarse_epochs = ceil(2 / 4) = 1 holds 4 views,
    so the two steps logged as fine run at the coarse stride (epoch 0)."""
    argv, out, epochs = tool_inputs
    trainer = run_multi_stylize.main(argv + ["--steps", "2", "--fine_steps", "2", "--i_save", "2"])
    captured = capsys.readouterr()
    assert json.loads(captured.out.strip().splitlines()[-1]) == {
        "prompts": PROMPTS, "steps": 4, "coarse": 2, "fine": 2, "resumed_from": 0, "out": out}
    assert "[multi] step 1/4 [coarse]" in captured.err and "[multi] step 4/4 [fine]" in captured.err
    assert epochs == [0, 0, 0, 0]  # the round-up: every step at the coarse stride
    assert trainer.cfg.coarse_epochs == 1 and trainer.cfg.fine_epochs == 1
    names = {f"multi_{p}_{tag}.pth.tar{ext}" for p in PROMPTS for tag in ("0002", "final")
             for ext in ("", ".fieldcfg.json")} | {f"multi_{p}_grid.npy" for p in PROMPTS}
    assert set(os.listdir(out)) == names
    for p, params, grid in zip(PROMPTS, trainer.params_list(), trainer.grids):
        jparams, jcfg = jax_load_params_with_config(os.path.join(out, f"multi_{p}_final.pth.tar"))
        assert jcfg == JAX_FCFG
        for a, b in zip(jax.tree_util.tree_leaves(map_leaves(params, lambda t: t.numpy())),
                        jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(np.load(os.path.join(out, f"multi_{p}_grid.npy")), grid.numpy())
    p0, p1 = trainer.params_list()
    assert any(not torch.equal(a, b) for a, b in zip(leaves(p0), leaves(p1)))  # the prompts diverge


def test_run_multi_stylize_resume_starts_a_fresh_adam(tool_inputs, capsys, monkeypatch):
    """A resume from the step-2 checkpoints and grids continues the save
    numbering with the remaining (fine) steps, from the saved parameters,
    and a fresh Adam (the JAX tool's choice: no optimizer state is saved):
    the resumed trainer's Adam has counted only its own steps."""
    argv, out, epochs = tool_inputs
    run_multi_stylize.main(argv + ["--steps", "2", "--fine_steps", "2", "--i_save", "2"])
    saved = {p: np.load(os.path.join(out, f"multi_{p}_grid.npy")) for p in PROMPTS}
    seen = {}
    real_init = ms.MultiPromptTrainer.__post_init__

    def capture(self):
        seen["params"] = ms.unstack_params(self.params_style, len(self.prompts))
        seen["grids"] = self.grids.clone()
        real_init(self)

    monkeypatch.setattr(ms.MultiPromptTrainer, "__post_init__", capture)
    trainer = run_multi_stylize.main(argv + ["--steps", "2", "--fine_steps", "2", "--resume_step", "2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["resumed_from"] == 2
    assert epochs[4:] == [0, 0] and trainer.cfg.coarse_epochs == 0  # the remaining steps are fine ones
    for p, prompt in enumerate(PROMPTS):
        want, _ = jax_load_params_with_config(os.path.join(out, f"multi_{prompt}_0002.pth.tar"))
        for a, b in zip(jax.tree_util.tree_leaves(map_leaves(seen["params"][p], lambda t: t.numpy())),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(seen["grids"][p].numpy(), saved[prompt])
    steps = {int(s["step"]) for s in trainer.opt.state.values()}
    assert steps == {2}  # a fresh Adam: two steps, not four
