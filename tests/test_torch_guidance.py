"""The rest of the port's guidance against the JAX package, on the CPU:
depth conditioning in SDS, txt2img (PNDM/PLMS and DDIM latents,
prompt_to_img), the toy guidance's palettes, its DDPM trainer with Adam,
and its checkpoint's save and load. Inputs are drawn from numpy
generators; weights are the JAX package's ``init_*`` carried across.

Tolerances:
* the depth channel the UNet receives (resized bicubic, min-max
  normalised to [-1, 1]): 1e-5 (measured 2.3e-6 at 32 -> 8: the resize's
  f32 error, about 1e-6 x max|depth|, times 2 / (max - min) of the
  resized map, here about 6);
* latents after 3 PNDM or DDIM steps: 1e-5 x max|ref| (measured 9.4e-7
  and 1.9e-6: the UNet's f32 error through classifier-free guidance at
  7.5 and the multistep combinations);
* prompt_to_img's uint8 images: at most 1 apart, where an image within
  1e-5 rounds to the other side of a half;
* style_map and apply_style: 1e-6 absolute (one f32 formula);
* the DDPM loss 1e-5 relative and each gradient leaf 1e-4 x its max|g|
  plus 1e-6 x the largest max|g| of all leaves (f32 sums in other orders
  through the UNet's forward and backward; a leaf whose gradient is zero
  but for rounding, such as a bias under a group norm, holds only that
  floor), with t, the noise and the uncond dropout drawn from the JAX
  package's key and injected;
* Adam: the port's three steps against optax.adam fed the same gradients,
  1e-5 relative (tests/test_torch_train.py's bound) and 1e-4 x lr absolute
  (measured 2.0e-5 x lr, on weights that pass near zero: optax computes
  the bias correction 1 - 0.999^t in f32, where it cancels to 2e-5
  relative at t <= 3, and torch in double; each step moves a weight by
  about lr); the three losses
  against the JAX package's own make_toy_train_step from the same start:
  1e-4 relative (its gradients differ by f32 orders, and Adam's first
  steps move each weight by about lr x sign(g));
* save -> load: bitwise, and the npz is the JAX package's flat layout.
"""

import contextlib
import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avatarcraft_tpu.models import diffusion as jdiff
from avatarcraft_tpu.models import sd as jsd
from avatarcraft_tpu.models import toy_guidance as jtoy
from avatarcraft_tpu.models.clip_tokenizer import make_toy_tokenizer as jax_toy_tokenizer
from avatarcraft_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from avatarcraft_tpu_torch.models import diffusion, sd, toy_guidance
from avatarcraft_tpu_torch.models.clip_tokenizer import make_toy_tokenizer
from avatarcraft_tpu_torch.utils.checkpoint import leaves, map_leaves
from tests.test_sd_modules import TINY_UNET, TINY_VAE
from tests.test_torch_toy_guidance import JAX_TINY, TINY, flat_params

LATENT_REL = 1e-5
DEPTH_ATOL = 1e-5
STYLE_ATOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
GRAD_FLOOR = 1e-6
ADAM_RTOL = 1e-5
ADAM_ATOL = 1e-4  # x lr
TRAJECTORY_RTOL = 1e-4
P_UNET = sd.UNetConfig(**dataclasses.asdict(TINY_UNET))
P_VAE = sd.VAEConfig(**dataclasses.asdict(TINY_VAE))
DROPOUT = 0.5  # some rows of a batch of 4 fall to the null embedding


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: tier-1 runs six
    pytest workers on the machine's cores, and workers whose torch ops each
    spread over every core oversubscribe it. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * np.abs(want).max(), rtol=0)


def _jax_tree(tree):
    """The port's tree as the JAX package's: numpy leaves, OIHW
    convolutions back to HWIO (the JAX package's own random inits compile
    one op at a time; the port's draws carry across in both directions)."""
    def leaf(t):
        a = t.detach().numpy()
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a

    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v) for v in tree]
    return None if tree is None else leaf(tree)


@pytest.fixture(scope="module")
def tiny_unet():
    """(JAX params, the port's) of the tiny SD UNet."""
    params = sd.init_unet_params(torch.Generator().manual_seed(0), P_UNET)
    return _jax_tree(params), params


# ---------------------------------------------------------------------------
# depth conditioning
# ---------------------------------------------------------------------------


def test_sds_depth_channel_matches_jax(rng):
    """SD 2.0-depth semantics with a recording UNet: the depth resized to
    the latent grid (cubic), min-max normalised to [-1, 1] over the whole
    map, concatenated as the fifth channel of both halves of the CFG pair;
    the gradient equal to the JAX package's."""
    seen = {}

    def make_unet(tanh, key):
        def unet(lat, t, ctx):
            seen[key] = np.asarray(lat)
            return tanh(lat[:, :4])
        return unet

    def jvae(images):
        B, C, H, W = images.shape
        lat = images.reshape(B, C, H // 2, 2, W // 2, 2).mean(axis=(3, 5))
        return jnp.concatenate([lat, lat[:, :1]], axis=1) * 0.18215

    def pvae(images):
        B, C, H, W = images.shape
        lat = images.reshape(B, C, H // 2, 2, W // 2, 2).mean(dim=(3, 5))
        return torch.cat([lat, lat[:, :1]], dim=1) * 0.18215

    jm = jdiff.GuidanceModules(unet=make_unet(jnp.tanh, "jax"), vae_encode=jvae, text_encode=None, latent_scale=2,
                               image_size=16, use_depth=True)
    pm = diffusion.GuidanceModules(unet=make_unet(torch.tanh, "port"), vae_encode=pvae, text_encode=None,
                                   latent_scale=2, image_size=16, use_depth=True)
    emb = rng.normal(size=(2, 4, 8)).astype(np.float32)
    img = rng.random((1, 3, 16, 16)).astype(np.float32)
    noise = rng.normal(size=(1, 4, 8, 8)).astype(np.float32)
    for src in (32, 8):  # shrunk (antialiased) and the identity
        depth = (rng.random((1, 1, src, src)) * 5 + 2).astype(np.float32)
        want = jdiff.SDSGuidance(jm).sds_image_grad(jax.random.PRNGKey(0), jnp.asarray(emb), jnp.asarray(img), 100.0,
                                                     pred_depth=jnp.asarray(depth), t_override=300,
                                                     noise_override=jnp.asarray(noise))
        got = diffusion.SDSGuidance(pm).sds_image_grad(torch.from_numpy(emb), torch.from_numpy(img), 100.0,
                                                       pred_depth=torch.from_numpy(depth), t_override=300,
                                                       noise_override=torch.from_numpy(noise))
        assert seen["port"].shape == seen["jax"].shape == (2, 5, 8, 8)
        d = seen["port"][:, 4]
        assert d.min() == pytest.approx(-1.0, abs=1e-6) and d.max() == pytest.approx(1.0, abs=1e-6)
        np.testing.assert_array_equal(d[0], d[1])
        np.testing.assert_allclose(d, seen["jax"][:, 4], atol=DEPTH_ATOL, rtol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    # without use_depth the depth is ignored: four channels
    pm4 = dataclasses.replace(pm, use_depth=False)
    diffusion.SDSGuidance(pm4).sds_image_grad(torch.from_numpy(emb), torch.from_numpy(img), 100.0,
                                              pred_depth=torch.from_numpy(depth), t_override=300,
                                              noise_override=torch.from_numpy(noise))
    assert seen["port"].shape == (2, 4, 8, 8)


# ---------------------------------------------------------------------------
# txt2img
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheduler", ["pndm", "ddim"])
def test_produce_latents_match_jax(tiny_unet, rng, scheduler):
    """3 steps (PNDM: 4 UNet calls, the warm start visiting the second
    timestep twice) from injected latents, CFG at 7.5."""
    jp, params = tiny_unet
    emb = rng.normal(size=(2, 6, 12)).astype(np.float32)
    x0 = rng.normal(size=(1, 4, 8, 8)).astype(np.float32)
    junet = jax.jit(lambda l, t, c: jsd.unet_apply(jp, TINY_UNET, l, t, c))
    calls = []

    def unet(l, t, c):
        calls.append(int(t[0]))
        return sd.unet_apply(params, P_UNET, l, t, c)

    jm = jdiff.GuidanceModules(unet=junet, vae_encode=None, text_encode=None, latent_scale=2, image_size=16)
    pm = diffusion.GuidanceModules(unet=unet, vae_encode=None, text_encode=None, latent_scale=2, image_size=16)
    want = jdiff.SDSGuidance(jm).produce_latents(jax.random.PRNGKey(0), jnp.asarray(emb), 16, 16, 3, 7.5,
                                                 latents=jnp.asarray(x0), scheduler=scheduler)
    got = diffusion.SDSGuidance(pm).produce_latents(torch.from_numpy(emb), 16, 16, 3, 7.5,
                                                    latents=torch.from_numpy(x0), scheduler=scheduler)
    assert calls == ([667, 334, 334, 1] if scheduler == "pndm" else [999, 500, 0])
    _close(got, want, LATENT_REL)
    # drawn from a generator: deterministic, of the latent shape
    g = diffusion.SDSGuidance(pm)
    a = g.produce_latents(torch.from_numpy(emb), 16, 16, 1, generator=torch.Generator().manual_seed(3))
    b = g.produce_latents(torch.from_numpy(emb), 16, 16, 1, generator=torch.Generator().manual_seed(3))
    assert a.shape == (1, 4, 8, 8) and torch.equal(a, b)


def test_prompt_to_img_matches_jax(tiny_unet, rng):
    """Tiny SD modules (UNet, decoder, CLIP behind the toy tokenizer)
    assembled by the port and by hand as the JAX loader assembles them;
    4 PNDM steps from injected latents to uint8 [1, 32, 32, 3]."""
    jp, params = tiny_unet
    tok = jax_toy_tokenizer()
    jccfg = jsd.CLIPTextConfig(vocab_size=len(tok.encoder), hidden_size=12, num_layers=2, num_heads=2, max_len=16)
    pccfg = sd.CLIPTextConfig(**dataclasses.asdict(jccfg))
    dec = sd.init_vae_decoder_params(torch.Generator().manual_seed(1), P_VAE)
    clip = sd.init_clip_text_params(torch.Generator().manual_seed(2), pccfg)
    jdec, jclip = _jax_tree(dec), _jax_tree(clip)
    jm = jdiff.GuidanceModules(
        unet=jax.jit(lambda l, t, c: jsd.unet_apply(jp, TINY_UNET, l, t, c)), vae_encode=None,
        text_encode=lambda ps: jsd.clip_text_apply(jclip, jccfg, jnp.asarray(tok(ps, max_length=16), jnp.int32)),
        latent_scale=2, image_size=32, vae_decode=jax.jit(lambda z: jsd.vae_decode_apply(jdec, TINY_VAE, z)),
    )
    pm = sd.assemble_stable_diffusion_modules(params, None, dec, clip, make_toy_tokenizer(), (P_UNET, P_VAE, pccfg),
                                              image_size=32)
    x0 = rng.normal(size=(1, 4, 16, 16)).astype(np.float32)
    want = jdiff.SDSGuidance(jm).prompt_to_img("hulk style", 32, 32, 4, latents=jnp.asarray(x0))
    got = diffusion.SDSGuidance(pm).prompt_to_img("hulk style", 32, 32, 4, latents=torch.from_numpy(x0))
    assert got.dtype == np.uint8 and got.shape == want.shape == (1, 32, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got != want).mean() < 0.01
    # initial latents drawn from a generator seeded 0 unless one is given
    g = diffusion.SDSGuidance(pm)
    assert np.array_equal(g.prompt_to_img("hulk", 32, 32, 1), g.prompt_to_img("hulk", 32, 32, 1))
    with pytest.raises(ValueError, match="VAE decoder"):
        diffusion.SDSGuidance(dataclasses.replace(pm, vae_decode=None)).prompt_to_img("hulk", 32, 32, 1)


# ---------------------------------------------------------------------------
# the toy guidance: palettes, DDPM, Adam, persistence
# ---------------------------------------------------------------------------


def test_style_map_and_apply_style_match_jax(rng):
    assert toy_guidance.STYLE_PALETTES == jtoy.STYLE_PALETTES and toy_guidance.STYLES == jtoy.STYLES
    rgb = rng.uniform(-0.1, 1.1, size=(5, 7, 3)).astype(np.float32)
    alpha = rng.random((5, 7)).astype(np.float32)
    for style in list(jtoy.STYLES) + [0, 1, 2]:
        np.testing.assert_allclose(toy_guidance.style_map(torch.from_numpy(rgb), style).numpy(),
                                   np.asarray(jtoy.style_map(jnp.asarray(rgb), style)), atol=STYLE_ATOL, rtol=0)
        np.testing.assert_allclose(
            toy_guidance.apply_style(torch.from_numpy(rgb), torch.from_numpy(alpha), style).numpy(),
            np.asarray(jtoy.apply_style(jnp.asarray(rgb), jnp.asarray(alpha), style)), atol=STYLE_ATOL, rtol=0)


def _jax_draws(key, B, size):
    """The t, noise and uncond dropout the JAX package's DDPM loss draws
    from ``key``, as torch tensors."""
    k_t, k_n, k_d = jax.random.split(key, 3)
    t = jax.random.randint(k_t, (B,), 0, 1000)
    noise = jax.random.normal(k_n, (B, 3, size, size))
    drop = jax.random.uniform(k_d, (B,)) < DROPOUT
    return {"t": torch.from_numpy(np.array(t)).long(), "noise": torch.from_numpy(np.array(noise)),
            "drop": torch.from_numpy(np.array(drop))}


@pytest.fixture(scope="module")
def toy_case():
    """(JAX params, embeddings, images [4, 16, 16, 3], style ids [4]) of
    the TINY toy guidance."""
    rng = np.random.default_rng(5)
    jparams = _jax_tree(sd.init_unet_params(torch.Generator().manual_seed(3), TINY.unet))
    embs = np.asarray(jtoy.style_embeddings(JAX_TINY))
    imgs = rng.random((4, 16, 16, 3)).astype(np.float32)
    ids = np.asarray([0, 2, 1, 0], np.int32)
    return jparams, embs, imgs, ids


def _port_leaves(params) -> dict:
    return {"/".join(k): v for k, v in _flat(params)}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def _jax_leaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        out["/".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path)] = (
            a.transpose(3, 2, 0, 1) if a.ndim == 4 else a)
    return out


def test_ddpm_loss_and_gradient_match_jax(toy_case):
    jparams, embs, imgs, ids = toy_case
    key = jax.random.PRNGKey(11)
    jloss_fn = jtoy._make_ddpm_loss(JAX_TINY, jdiff.DiffusionSchedule(), DROPOUT)
    want, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(jparams, jnp.asarray(imgs), jnp.asarray(ids), key)
    params = map_leaves(sd.params_from_jax(_np_tree(jparams), "cpu"), lambda t: t.requires_grad_())
    draws = _jax_draws(key, 4, 16)
    assert 0 < int(draws["drop"].sum()) < 4
    loss_fn = toy_guidance.make_ddpm_loss(TINY, torch.from_numpy(embs), uncond_dropout=DROPOUT)
    loss = loss_fn(params, torch.from_numpy(imgs), torch.from_numpy(ids), **draws)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=LOSS_RTOL)
    jg, pg = _jax_leaves(jgrads), _port_leaves(params)
    assert set(jg) == set(pg) and len(jg) > 100
    floor = GRAD_FLOOR * max(np.abs(w).max() for w in jg.values())
    for k, w in jg.items():
        np.testing.assert_allclose(pg[k].grad.numpy(), w, atol=GRAD_REL * np.abs(w).max() + floor, rtol=0,
                                   err_msg=k)
    # the generator's draws: t, then the noise, then the dropout
    gen = torch.Generator().manual_seed(2)
    t = torch.randint(0, 1000, (4,), generator=gen)
    noise = torch.randn((4, 3, 16, 16), generator=gen)
    drop = torch.rand((4,), generator=gen) < DROPOUT
    with torch.no_grad():
        a = loss_fn(params, torch.from_numpy(imgs), torch.from_numpy(ids), torch.Generator().manual_seed(2))
        b = loss_fn(params, torch.from_numpy(imgs), torch.from_numpy(ids), t=t, noise=noise, drop=drop)
    assert torch.equal(a, b)


def test_three_adam_steps_match_optax(toy_case):
    jparams, embs, imgs, ids = toy_case
    lr = 1e-3
    keys = [jax.random.PRNGKey(20 + i) for i in range(3)]
    # the JAX package's trainer from the same start, for its losses
    tx = optax.adam(lr)
    jstep = jtoy.make_toy_train_step(JAX_TINY, tx, uncond_dropout=DROPOUT)
    jp, state, jlosses = jparams, tx.init(jparams), []
    for k in keys:
        jp, state, loss = jstep(jp, state, jnp.asarray(imgs), jnp.asarray(ids), k)
        jlosses.append(float(loss))

    params = map_leaves(sd.params_from_jax(_np_tree(jparams), "cpu"), lambda t: t.requires_grad_())
    opt = torch.optim.Adam(leaves(params), lr=lr)
    step = toy_guidance.make_toy_train_step(TINY, torch.from_numpy(embs), opt, uncond_dropout=DROPOUT)
    start = {k: v.detach().numpy().copy() for k, v in _port_leaves(params).items()}
    losses, grads = [], []
    for k in keys:
        losses.append(float(step(params, torch.from_numpy(imgs), torch.from_numpy(ids), **_jax_draws(k, 4, 16))))
        grads.append({k2: v.grad.numpy().copy() for k2, v in _port_leaves(params).items()})
    np.testing.assert_allclose(losses, jlosses, rtol=TRAJECTORY_RTOL)

    # optax.adam on the port's own gradients
    p = start
    ostate = tx.init(p)
    for g in grads:
        up, ostate = tx.update(g, ostate, p)
        p = optax.apply_updates(p, up)
    for k, v in _port_leaves(params).items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(p[k]), rtol=ADAM_RTOL, atol=ADAM_ATOL * lr,
                                   err_msg=k)


def test_train_scan_is_the_steps_in_order(toy_case):
    """make_toy_train_scan: the S steps with one optimizer, drawing from
    one generator, equal to S calls of the step."""
    jparams, embs, imgs, ids = toy_case
    batches = torch.from_numpy(np.stack([imgs, imgs[::-1].copy()])), torch.from_numpy(np.stack([ids, ids[::-1].copy()]))
    out = []
    for scan in (True, False):
        params = map_leaves(sd.params_from_jax(_np_tree(jparams), "cpu"), lambda t: t.requires_grad_())
        opt = torch.optim.Adam(leaves(params), lr=1e-3)
        gen = torch.Generator().manual_seed(4)
        if scan:
            losses = toy_guidance.make_toy_train_scan(TINY, torch.from_numpy(embs), opt)(params, *batches, gen)
        else:
            step = toy_guidance.make_toy_train_step(TINY, torch.from_numpy(embs), opt)
            losses = torch.stack([step(params, b, i, gen) for b, i in zip(*batches)])
        out.append((losses, leaves(params)))
    assert out[0][0].shape == (2,) and torch.isfinite(out[0][0]).all() and torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_save_then_load_toy_guidance(tmp_path, toy_case):
    """save_toy_guidance writes what load_toy_guidance reads: the tree
    (empty attention lists and missing resampling convs included), the
    config and the embeddings, bitwise; params/ holds the JAX package's
    layout (its orbax restore, flattened, is the JAX tree's flat layout),
    the npz the embeddings, and config.json the JAX keys."""
    jparams, embs, _, _ = toy_case
    params = sd.params_from_jax(_np_tree(jparams), "cpu")
    path = str(tmp_path / "toy")
    toy_guidance.save_toy_guidance(path, params, TINY, torch.from_numpy(embs))
    loaded, cfg, lembs = toy_guidance.load_toy_guidance(path, device="cpu")
    assert cfg == TINY and torch.equal(lembs, torch.from_numpy(embs))
    assert jax.tree_util.tree_structure(loaded) == jax.tree_util.tree_structure(params)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(params)))
    with np.load(os.path.join(path, toy_guidance.WEIGHTS_FILE)) as z:
        assert z.files == ["style_embeddings"] and np.array_equal(z["style_embeddings"], embs)
    want, got = flat_params(jparams), flat_params(jax_load_checkpoint(os.path.join(path, "params"))["params"])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    with open(os.path.join(path, "config.json")) as fp:
        written = json.load(fp)
    assert written == json.loads(json.dumps({k: getattr(JAX_TINY, k) for k in toy_guidance.CONFIG_KEYS}))
    assert list(written) == list(toy_guidance.CONFIG_KEYS)


# ---------------------------------------------------------------------------
# the profile's split: the trainer's vae, sds and phaseB ranges
# ---------------------------------------------------------------------------


def _event(name, start, end, thread=1, kernels=(), children=(), device="cpu"):
    from torch.autograd import DeviceType

    e = types.SimpleNamespace(
        name=name, thread=thread, cpu_parent=None, cpu_children=list(children),
        device_type=DeviceType.CPU if device == "cpu" else DeviceType.CUDA,
        kernels=[types.SimpleNamespace(name=k, duration=d) for k, d in kernels],
        time_range=types.SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start),
    )
    for c in children:
        c.cpu_parent = e
    return e


def test_stylize_split_counts_the_vae_once():
    """profile_train's split: each stylize range counts the kernels of the
    ops under it (the encode's in its vae range, the UNet's in sds);
    kernels of the autograd engine's thread go to the range open when
    their op began (the encoder's pullback to vae, the patches' backward
    to phaseB), else to phaseB; the table kernels once each, by their own
    device events."""
    from avatarcraft_tpu_torch import profile_train

    vae1 = _event("stylize.vae", 10, 20, children=[_event("aten::conv2d", 11, 12, kernels=[("cudnn_conv", 5.0)])])
    sds = _event("stylize.sds", 20, 80, children=[_event("aten::conv2d", 30, 40, kernels=[("cudnn_conv", 7.0)])])
    vae2 = _event("stylize.vae", 80, 95)
    patch = _event("aten::mul", 110, 120, kernels=[("mul", 3.0)])
    phase_b = _event("stylize.phaseB", 100, 200, children=[patch])
    engine = [_event("autograd::conv_bwd", 85, 90, thread=2, kernels=[("dgrad", 11.0)]),
              _event("autograd::mul_bwd", 150, 160, thread=2, kernels=[("mul", 13.0)]),
              _event("autograd::sum_bwd", 250, 260, thread=2, kernels=[("sum", 17.0)])]
    gather = _event("gather_rows_kernel", 0, 2, device="cuda")
    scatter = _event("reduce_scatter_rows_kernel", 0, 4, device="cuda")
    events = [vae1, *vae1.cpu_children, sds, *sds.cpu_children, vae2, phase_b, patch, *engine, gather, scatter]
    ms = profile_train._phase_device_ms(types.SimpleNamespace(events=lambda: events), "stylize",
                                        profile_train.STYLIZE_PHASES, "phaseB")
    assert {k: round(v * 1e3, 6) for k, v in ms.items()} == {
        "gather": 2.0, "phaseA": 0.0, "sds": 7.0, "vae": 16.0, "phaseB": 37.0, "refresh": 0.0}


def test_sds_scope_wraps_each_part():
    """sds_image_grad runs its parts in the caller's scope: the encode,
    the UNet's pair, the pullback (the trainer's profiler ranges), and
    gives the same gradient as without a scope."""
    g = diffusion.SDSGuidance(diffusion.make_dummy_modules(image_size=16, device="cpu"))
    emb = g.get_text_embeds(["lava"])
    img = torch.from_numpy(np.random.default_rng(3).random((1, 3, 8, 8)).astype(np.float32))
    parts = []

    def scope(part):
        parts.append(part)
        return contextlib.nullcontext()

    noise = torch.zeros((1, 4, 2, 2))
    got = g.sds_image_grad(emb, img, 100.0, t_override=400, noise_override=noise, scope=scope)
    assert parts == ["vae", "sds", "vae"]
    assert torch.equal(got, g.sds_image_grad(emb, img, 100.0, t_override=400, noise_override=noise))


def test_device_busy_is_the_union_of_intervals():
    """Kernels on other streams overlap: busy time is the union of their
    intervals, never more than the span they cover."""
    from avatarcraft_tpu_torch.utils.timing import busy_us

    events = [_event(k, a, b, device="cuda") for k, a, b in
              [("a", 0, 10), ("b", 5, 12), ("c", 20, 25), ("d", 21, 22), ("e", 30, 30)]]
    assert busy_us(events) == 17.0
    assert busy_us(events[::-1]) == 17.0 and busy_us([]) == 0.0
