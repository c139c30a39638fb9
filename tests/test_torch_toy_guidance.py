"""The port's guidance (models/sd.py UNet, models/diffusion.py SDS,
models/toy_guidance.py) against the JAX package, on the CPU, with inputs
drawn from numpy generators.

Run as a script, this file writes ``artifacts/toy_guidance/params_torch.npz``
from the orbax checkpoint beside it through the JAX package's
``load_toy_guidance`` (the card's machine has neither JAX nor orbax):

    JAX_PLATFORMS=cpu python tests/test_torch_toy_guidance.py

Tolerances:
* the committed npz against the orbax checkpoint: bitwise, every leaf and
  the style embeddings;
* UNet eps: 1e-5 absolute at the TINY config (measured 1.3e-6 on |eps| up
  to 1.3) and at the committed config with the committed weights (measured
  2.9e-6 on |eps| up to 6.6: f32 sums in other orders through 3 levels of
  convolutions, group norms and attention);
* the bilinear resize and its pullback against ``jax.image.resize`` /
  ``jax.vjp``: 1e-6 absolute at 256 -> 64 (antialiased), 64 -> 64
  (identity) and 32 -> 64 (upsampling);
* the SDS image gradient with t and the noise injected: 2 x 201 x the eps
  tolerance (4.0e-3) absolute. Classifier-free guidance at scale 100 turns
  an eps error e into up to (2 x 100 + 1) e in eps_hat, times w(t) <= 1
  before the +-1 clamp, and the toy encoder's pullback doubles it
  (measured 4.1e-4 at 64 -> 64, t = 500; 3.2e-5 and 9.5e-7 at 256 -> 64,
  where the pullback spreads it over 16 pixels);
* text embeddings, the schedule, the style lookup: exact.

The dummy guidance's text encoder seeds from Python's salted
``hash(prompt)`` in both packages, so its embeddings differ from process to
process and are not held against JAX; its UNet and encoder are, on the same
embeddings.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.models import diffusion as jdiff
from avatarcraft_tpu.models import sd as jsd
from avatarcraft_tpu.models import toy_guidance as jtoy
from avatarcraft_tpu_torch.models import diffusion, sd, toy_guidance
from avatarcraft_tpu_torch.utils.checkpoint import leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_DIR = os.path.join(REPO, "artifacts", "toy_guidance")
EPS_ATOL = 1e-5
RESIZE_ATOL = 1e-6
SDS_ATOL = 2 * 201 * EPS_ATOL

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


def flat_params(params) -> dict:
    """The JAX tree's leaves under "params/<keys joined by '/'>", in its
    flattening order (dict keys sorted, lists in order)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path)
        out["params/" + key] = np.asarray(leaf)
    return out


def write_weights(path: str = TOY_DIR) -> str:
    """Write params_torch.npz beside the orbax checkpoint in ``path``."""
    params, cfg = jtoy.load_toy_guidance(path)
    out = os.path.join(path, toy_guidance.WEIGHTS_FILE)
    np.savez(out, style_embeddings=np.asarray(jtoy.style_embeddings(cfg)), **flat_params(params))
    return out


@pytest.fixture(scope="module")
def committed():
    """(JAX params, JAX config, port params, port config, embeddings) of the
    committed toy guidance."""
    jparams, jcfg = jtoy.load_toy_guidance(TOY_DIR)
    params, cfg, embs = toy_guidance.load_toy_guidance(TOY_DIR, device="cpu")
    return jparams, jcfg, params, cfg, embs


def _jax_unet(jparams, jcfg):
    return jax.jit(lambda p, l, t, c: jsd.unet_apply(p, jcfg.unet, l, t, c))


def test_committed_npz_matches_orbax(committed):
    jparams, jcfg, _, cfg, embs = committed
    with np.load(os.path.join(TOY_DIR, toy_guidance.WEIGHTS_FILE)) as z:
        want = flat_params(jparams)
        assert sorted(z.files) == sorted(list(want) + ["style_embeddings"])
        for k, w in want.items():
            assert z[k].dtype == w.dtype and z[k].shape == w.shape, k
            np.testing.assert_array_equal(z[k], w, err_msg=k)
        np.testing.assert_array_equal(z["style_embeddings"], np.asarray(jtoy.style_embeddings(jcfg)))
    np.testing.assert_array_equal(embs.numpy(), np.asarray(jtoy.style_embeddings(jcfg)))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_loaded_tree_matches_jax(committed):
    """The loader rebuilds the JAX tree: the same structure (empty attention
    lists and missing resampling convs included), HWIO -> OIHW."""
    jparams, _, params, _, _ = committed
    assert [b["attns"] == [] for b in params["down"]] == [b["attns"] == [] for b in jparams["down"]]
    assert [b["down"] is None for b in params["down"]] == [b["down"] is None for b in jparams["down"]]
    assert [b["up"] is None for b in params["up"]] == [b["up"] is None for b in jparams["up"]]
    jl = jax.tree_util.tree_leaves(jparams)
    pl = [t for t in _sorted_leaves(params)]
    assert len(jl) == len(pl) == 368
    for w, g in zip(jl, pl):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy(), w.transpose(3, 2, 0, 1) if w.ndim == 4 else w)


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [] if tree is None else [tree]


def test_init_unet_params_tree():
    jparams = jtoy.init_toy_params(jax.random.PRNGKey(0), JAX_TINY)
    params = sd.init_unet_params(torch.Generator().manual_seed(0), TINY.unet)
    jl, pl = jax.tree_util.tree_leaves(jparams), _sorted_leaves(params)
    assert len(jl) == len(pl)
    for w, g in zip(jl, pl):
        shape = np.asarray(w).shape
        assert tuple(g.shape) == ((shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape)
    again = sd.init_unet_params(torch.Generator().manual_seed(0), TINY.unet)
    assert all(torch.equal(a, b) for a, b in zip(leaves(params), leaves(again)))


def test_unet_eps_matches_jax_tiny(rng):
    jparams = jtoy.init_toy_params(jax.random.PRNGKey(3), JAX_TINY)
    params = sd.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    lat = rng.normal(size=(2, 3, 16, 16)).astype(np.float32)
    t = np.asarray([500, 37], np.int32)
    ctx = rng.normal(size=(2, 2, 8)).astype(np.float32)
    want = np.asarray(_jax_unet(jparams, JAX_TINY)(jparams, lat, t, ctx))
    got = sd.unet_apply(params, TINY.unet, torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), want, atol=EPS_ATOL, rtol=0)


def test_unet_eps_matches_jax_committed(committed, rng):
    jparams, jcfg, params, cfg, embs = committed
    lat = rng.normal(size=(2, 3, 64, 64)).astype(np.float32)
    t = np.asarray([981, 20], np.int32)
    ctx = np.asarray(jtoy.style_embeddings(jcfg))[[3, 0]]
    want = np.asarray(_jax_unet(jparams, jcfg)(jparams, lat, t, ctx))
    got = sd.unet_apply(params, cfg.unet, torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx))
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=EPS_ATOL, rtol=0)


@pytest.mark.parametrize("src,dst", [(256, 64), (64, 64), (32, 64)])
def test_resize_and_pullback_match_jax(rng, src, dst):
    img = rng.random((1, 3, src, src)).astype(np.float32)
    ct = rng.normal(size=(1, 3, dst, dst)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jax.image.resize(x, (1, 3, dst, dst), method="bilinear"), jnp.asarray(img))
    (want_g,) = vjp(jnp.asarray(ct))
    x = torch.from_numpy(img).requires_grad_()
    got = diffusion.resize_bilinear(x, dst)
    (got_g,) = torch.autograd.grad(got, x, torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=RESIZE_ATOL, rtol=0)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=RESIZE_ATOL, rtol=0)


def test_get_text_embeds_matches_jax(committed):
    jparams, jcfg, params, cfg, embs = committed
    prompts = ["front view of the body of the lava", "", "side view of the face of the porcelain", "zombie"]
    want = jdiff.SDSGuidance(jtoy.make_toy_modules(jparams, jcfg)).get_text_embeds(prompts)
    got = diffusion.SDSGuidance(toy_guidance.make_toy_modules(params, cfg, embs)).get_text_embeds(prompts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [toy_guidance.style_index(p) for p in prompts] == [jtoy.style_index(p) for p in prompts]
    assert toy_guidance.STYLES == jtoy.STYLES


def test_schedule_matches_jax():
    a, b = diffusion.DiffusionSchedule(), jdiff.DiffusionSchedule()
    np.testing.assert_array_equal(a.alphas_cumprod, b.alphas_cumprod)
    assert (a.min_step, a.max_step) == (b.min_step, b.max_step) == (20, 980)


@pytest.mark.parametrize("src,t", [(64, 500), (256, 731), (256, 25)])
def test_sds_image_grad_matches_jax(committed, rng, src, t):
    """64 -> 64 (the coarse frame) and 256 -> 64 (the fine frame,
    antialiased downscale), with t and the noise injected."""
    jparams, jcfg, params, cfg, embs = committed
    jguide = jdiff.SDSGuidance(jtoy.make_toy_modules(jparams, jcfg))
    guide = diffusion.SDSGuidance(toy_guidance.make_toy_modules(params, cfg, embs))
    prompt = "front view of the body of the lava"
    img = rng.random((1, 3, src, src)).astype(np.float32)
    noise = rng.normal(size=(1, 3, 64, 64)).astype(np.float32)
    want = jax.jit(lambda i, n: jguide.sds_image_grad(
        jax.random.PRNGKey(0), jguide.get_text_embeds([prompt]), i, 100.0, t_override=t, noise_override=n
    ))(img, noise)
    got = guide.sds_image_grad(guide.get_text_embeds([prompt]), torch.from_numpy(img), 100.0,
                               t_override=t, noise_override=torch.from_numpy(noise))
    want = np.asarray(want)
    assert got.shape == want.shape == (1, 3, src, src)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, atol=SDS_ATOL, rtol=0)


def test_sds_draws_t_and_noise_from_the_generator(committed, rng):
    _, _, params, cfg, embs = committed
    guide = diffusion.SDSGuidance(toy_guidance.make_toy_modules(params, cfg, embs))
    emb = guide.get_text_embeds(["lava"])
    img = torch.from_numpy(rng.random((1, 3, 64, 64)).astype(np.float32))
    a = guide.sds_image_grad(emb, img, generator=torch.Generator().manual_seed(7))
    b = guide.sds_image_grad(emb, img, generator=torch.Generator().manual_seed(7))
    c = guide.sds_image_grad(emb, img, generator=torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    gen = torch.Generator().manual_seed(7)
    t = int(torch.randint(20, 981, (1,), generator=gen))
    noise = torch.randn((1, 3, 64, 64), generator=gen)
    assert torch.equal(a, guide.sds_image_grad(emb, img, t_override=t, noise_override=noise))


def test_dummy_modules_match_jax(rng):
    """The dummy guidance's UNet and encoder, and SDS through them at
    32 -> 64 (upsampling), on embeddings given to both packages."""
    jmods = jdiff.make_dummy_modules(image_size=64)
    mods = diffusion.make_dummy_modules(image_size=64, device="cpu")
    emb = rng.normal(size=(2, 8, 32)).astype(np.float32)
    lat = rng.normal(size=(2, 4, 8, 8)).astype(np.float32)
    t = np.asarray([300, 300], np.int32)
    np.testing.assert_allclose(mods.unet(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(emb)).numpy(),
                               np.asarray(jmods.unet(lat, t, emb)), atol=1e-6, rtol=0)
    img = rng.random((1, 3, 64, 64)).astype(np.float32)
    np.testing.assert_allclose(mods.vae_encode(torch.from_numpy(img)).numpy(), np.asarray(jmods.vae_encode(img)),
                               atol=1e-7, rtol=0)
    small = rng.random((1, 3, 32, 32)).astype(np.float32)
    noise = rng.normal(size=(1, 4, 8, 8)).astype(np.float32)
    want = jdiff.SDSGuidance(jmods).sds_image_grad(jax.random.PRNGKey(0), emb, small, 100.0, t_override=300,
                                                   noise_override=noise)
    got = diffusion.SDSGuidance(mods).sds_image_grad(torch.from_numpy(emb), torch.from_numpy(small), 100.0,
                                                     t_override=300, noise_override=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    e1 = mods.text_encode(["lava", "lava", ""])
    assert e1.shape == (3, 8, 32) and torch.equal(e1[0], e1[1]) and not torch.equal(e1[0], e1[2])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(f"wrote {write_weights()}")
