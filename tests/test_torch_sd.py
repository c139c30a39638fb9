"""The port's Stable Diffusion modules (models/sd.py: the VAE encoder and
decoder, CLIP, the converters, KeyAudit and the loader) and its CLIP
tokenizer (models/clip_tokenizer.py) against the JAX package, on the CPU at
the TINY configs of tests/test_sd_modules.py, with inputs drawn from numpy
generators and weights from the JAX package's ``init_*`` carried across.

Tolerances:
* module outputs (VAE encode, decode, CLIP) and the encoder's pullback:
  1e-5 x max|ref| (measured 8.7e-7, 8.9e-7, 3.3e-7 and 1.3e-6: f32 sums in
  other orders);
* converters: every leaf bitwise equal to the JAX converter's (a copy and,
  for convolutions, HWIO -> OIHW);
* the loader end to end, on the same torch.save'd files as the JAX loader:
  text embeddings 1e-5 x max|ref|; the SDS image gradient with t and the
  noise injected 201 x 1e-5 x max|ref| (classifier-free guidance at 100
  turns an eps error e into up to 201 e before the clamp; the VAE's
  pullback spreads it); the decoded image 1e-5;
* tokenizer ids: exact, on ASCII and listed non-ASCII prompts, and the word
  split on every code point this Python's ``unicodedata`` assigns. The
  port splits with the standard library's ``re`` and classes built from
  ``unicodedata`` where the JAX package uses ``regex``: they differ only on
  code points that a newer Unicode version than this Python's assigns
  (``regex`` ships newer tables), such as U+088F (a letter assigned after
  Unicode 15.0, this Python's version), which the port splits as
  unassigned.
"""

import dataclasses
import unicodedata

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.models import clip_tokenizer as jtok
from avatarcraft_tpu.models import diffusion as jdiff
from avatarcraft_tpu.models import sd as jsd
from avatarcraft_tpu_torch.models import clip_tokenizer, diffusion, sd
from tests.test_clip_tokenizer import PROMPTS
from tests.test_sd_converters import _lin_sd, _norm_sd, _r, build_unet_sd, build_vae_sd
from tests.test_sd_modules import TINY_CLIP, TINY_UNET, TINY_VAE

MODULE_REL = 1e-5
SDS_REL = 201 * MODULE_REL

P_UNET = sd.UNetConfig(**dataclasses.asdict(TINY_UNET))
P_VAE = sd.VAEConfig(**dataclasses.asdict(TINY_VAE))
P_CLIP = sd.CLIPTextConfig(**dataclasses.asdict(TINY_CLIP))
# SD 2.0-depth's geometry at the tiny width: 5 input channels, heads per block
TINY_UNET_DEPTH = dataclasses.replace(TINY_UNET, in_channels=5, attention_head_dim=(2, 4), attn_blocks=(True, True))
NON_ASCII = [
    "café crème brûlée à la carte",
    "Ünïcödé ÑANDÚ Straße",
    "東京タワー の 写真",
    "x² + y³ = ½ of ¼",
    "Ⅻ roman twelve ⅻ",
    "٣ arabic-indic digits ٤٥",
    "emoji 😀🔥 lava",
    "combining é and iotaͅ subscript",
    "nbsp em ideographic　space",
    "file\x1cseparator\x1funit",
    "Ελληνικά ΣΑΣ русский текст",
]


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


def _jax_init(init, seed, cfg):
    """The JAX package's random tree, drawn in one jitted call (its eager
    draws compile one op at a time)."""
    return jax.jit(init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * np.abs(want).max(), rtol=0)


def assert_tree_equal(port, jtree, path="root"):
    """The port's tree is the JAX tree, leaf for leaf: the same structure,
    every leaf bitwise equal (convolutions HWIO -> OIHW)."""
    if isinstance(jtree, dict):
        assert isinstance(port, dict) and set(port) == set(jtree), path
        for k in jtree:
            assert_tree_equal(port[k], jtree[k], f"{path}.{k}")
    elif isinstance(jtree, list):
        assert isinstance(port, list) and len(port) == len(jtree), path
        for i, (a, b) in enumerate(zip(port, jtree)):
            assert_tree_equal(a, b, f"{path}.{i}")
    elif jtree is None:
        assert port is None, path
    else:
        w = np.asarray(jtree)
        w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w
        assert port.dtype == torch.float32, path
        np.testing.assert_array_equal(port.numpy(), w, err_msg=path)


def build_clip_sd(cfg, seed: int = 0) -> dict:
    """A random transformers CLIPTextModel state dict at ``cfg`` (the JAX
    package's CLIPTextConfig), with the position_ids buffer older versions
    save."""
    torch.manual_seed(seed)
    sd_, d = {}, cfg.hidden_size
    sd_["text_model.embeddings.token_embedding.weight"] = _r(cfg.vocab_size, d)
    sd_["text_model.embeddings.position_embedding.weight"] = _r(cfg.max_len, d)
    sd_["text_model.embeddings.position_ids"] = torch.arange(cfg.max_len)[None]
    for i in range(cfg.num_layers):
        pre = f"text_model.encoder.layers.{i}"
        _norm_sd(sd_, f"{pre}.layer_norm1", d)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin_sd(sd_, f"{pre}.self_attn.{n}", d, d)
        _norm_sd(sd_, f"{pre}.layer_norm2", d)
        _lin_sd(sd_, f"{pre}.mlp.fc1", d, 4 * d)
        _lin_sd(sd_, f"{pre}.mlp.fc2", 4 * d, d)
    _norm_sd(sd_, "text_model.final_layer_norm", d)
    return sd_


def _new_vae_keys(sd_: dict) -> dict:
    """The >= 0.17 diffusers key era of the VAE's mid attention."""
    names = {".query": ".to_q", ".key": ".to_k", ".value": ".to_v", ".proj_attn": ".to_out.0"}
    out = {}
    for k, v in sd_.items():
        for a, b in names.items():
            k = k.replace(".attentions.0" + a + ".", ".attentions.0" + b + ".")
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_vae_encoder_and_pullback_match_jax(rng):
    jp = _jax_init(jsd.init_vae_encoder_params, 0, TINY_VAE)
    params = sd.params_from_jax(_np_tree(jp), "cpu")
    img = rng.random((2, 3, 32, 32)).astype(np.float32)
    ct = rng.normal(size=(2, 4, 16, 16)).astype(np.float32)

    @jax.jit
    def encode_and_pullback(p, x, c):
        out, vjp = jax.vjp(lambda y: jsd.vae_encode_apply(p, TINY_VAE, y), x)
        return out, vjp(c)[0]

    want, want_g = encode_and_pullback(jp, jnp.asarray(img), jnp.asarray(ct))
    x = torch.from_numpy(img).requires_grad_()
    got = sd.vae_encode_apply(params, P_VAE, x)
    (got_g,) = torch.autograd.grad(got, x, torch.from_numpy(ct))
    assert got.shape == (2, 4, 16, 16)
    _close(got.detach(), want, MODULE_REL)
    _close(got_g, want_g, MODULE_REL)


def test_vae_decoder_matches_jax(rng):
    jp = _jax_init(jsd.init_vae_decoder_params, 1, TINY_VAE)
    params = sd.params_from_jax(_np_tree(jp), "cpu")
    lat = (rng.normal(size=(2, 4, 16, 16)) * 0.2).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jsd.vae_decode_apply(p, TINY_VAE, x))(jp, jnp.asarray(lat)))
    got = sd.vae_decode_apply(params, P_VAE, torch.from_numpy(lat))
    assert got.shape == (2, 3, 32, 32) and 0.0 < want.mean() < 1.0
    _close(got, want, MODULE_REL)


def test_clip_matches_jax(rng):
    jp = _jax_init(jsd.init_clip_text_params, 2, TINY_CLIP)
    params = sd.params_from_jax(_np_tree(jp), "cpu")
    ids = rng.integers(0, TINY_CLIP.vocab_size, (2, TINY_CLIP.max_len))
    want = np.asarray(jax.jit(lambda p, i: jsd.clip_text_apply(p, TINY_CLIP, i))(jp, jnp.asarray(ids)))
    got = sd.clip_text_apply(params, P_CLIP, torch.from_numpy(ids))
    _close(got, want, MODULE_REL)
    # causal: a later token leaves the earlier positions as they were
    ids2 = ids.copy()
    ids2[0, 5] = (ids2[0, 5] + 1) % TINY_CLIP.vocab_size
    got2 = sd.clip_text_apply(params, P_CLIP, torch.from_numpy(ids2))
    assert torch.equal(got2[0, :5], got[0, :5]) and not torch.equal(got2[0, 5:], got[0, 5:])


@pytest.mark.parametrize("init,jinit,cfg,jcfg", [
    (sd.init_vae_encoder_params, jsd.init_vae_encoder_params, P_VAE, TINY_VAE),
    (sd.init_vae_decoder_params, jsd.init_vae_decoder_params, P_VAE, TINY_VAE),
    (sd.init_clip_text_params, jsd.init_clip_text_params, P_CLIP, TINY_CLIP),
])
def test_init_trees_match_jax_shapes(init, jinit, cfg, jcfg):
    """The port's random trees have the JAX package's structure and shapes
    (their values are torch's draws) and are deterministic in the seed."""
    shapes = jax.eval_shape(lambda k: jinit(k, jcfg), jax.random.PRNGKey(0))
    params = init(torch.Generator().manual_seed(0), cfg)
    same = jax.tree_util.tree_map(lambda t: t.shape, params)
    want = jax.tree_util.tree_map(lambda a: (a.shape[3], a.shape[2], *a.shape[:2]) if a.ndim == 4 else a.shape,
                                  shapes)
    assert same == want
    again = init(torch.Generator().manual_seed(0), cfg)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(again)))


# ---------------------------------------------------------------------------
# converters and the loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ucfg", [TINY_UNET, TINY_UNET_DEPTH], ids=["1.5", "2.0-depth"])
def test_unet_converter_matches_jax(ucfg):
    torch.manual_seed(3)
    state = build_unet_sd(ucfg)
    got = sd.unet_params_from_torch(state, sd.UNetConfig(**dataclasses.asdict(ucfg)), "cpu")
    assert_tree_equal(got, jsd.unet_params_from_torch(state, ucfg))


@pytest.mark.parametrize("era", ["query/key/value", "to_q/to_k/to_v"])
@pytest.mark.parametrize("half", ["whole", "encoder only"])
def test_vae_converters_match_jax(era, half):
    torch.manual_seed(4)
    state = build_vae_sd(TINY_VAE)
    if era == "to_q/to_k/to_v":
        state = _new_vae_keys(state)
    if half == "encoder only":
        state = {k: v for k, v in state.items() if k.startswith(("encoder.", "quant_conv."))}
    assert_tree_equal(sd.vae_encoder_params_from_torch(state, P_VAE, "cpu"),
                      jsd.vae_encoder_params_from_torch(state, TINY_VAE))
    if half == "whole":
        assert_tree_equal(sd.vae_decoder_params_from_torch(state, P_VAE, "cpu"),
                          jsd.vae_decoder_params_from_torch(state, TINY_VAE))


@pytest.mark.parametrize("clip_cfg", [TINY_CLIP, dataclasses.replace(TINY_CLIP, hidden_size=24, num_layers=3,
                                                                        num_heads=4)], ids=["1.5", "2.0"])
def test_clip_converter_matches_jax(clip_cfg):
    state = build_clip_sd(clip_cfg)
    got = sd.clip_text_params_from_torch(state, sd.CLIPTextConfig(**dataclasses.asdict(clip_cfg)), "cpu")
    assert_tree_equal(got, jsd.clip_text_params_from_torch(state, clip_cfg))


def test_key_audit_refuses_a_stray_key():
    torch.manual_seed(5)
    audit = sd.KeyAudit(build_vae_sd(TINY_VAE))
    sd.vae_encoder_params_from_torch(audit, P_VAE, "cpu")
    # the decoder's keys are the only ones the encoder leaves
    assert audit.unconsumed() and all(k.startswith(("decoder.", "post_quant_conv.")) for k in audit.unconsumed())
    sd.vae_decoder_params_from_torch(audit, P_VAE, "cpu")
    audit.refuse_unconsumed("vae.pt")  # everything read
    audit = sd.KeyAudit({**build_clip_sd(TINY_CLIP), "text_model.extra_proj.weight": torch.zeros(2, 2)})
    sd.clip_text_params_from_torch(audit, P_CLIP, "cpu")
    assert audit.unconsumed() == ["text_model.extra_proj.weight"]  # position_ids is a buffer, ignored
    with pytest.raises(ValueError, match="extra_proj"):
        audit.refuse_unconsumed("text_encoder.pt")


def _write_sd_files(path, version: str, stray: str | None = None):
    """unet.pt, vae.pt, text_encoder.pt and tokenizer/ at the tiny width
    (the UNet's context is CLIP's width); the JAX configs."""
    tok = jtok.make_toy_tokenizer()
    ccfg = jsd.CLIPTextConfig(vocab_size=len(tok.encoder), hidden_size=12, num_layers=2, num_heads=2, max_len=16)
    ucfg = TINY_UNET_DEPTH if version == "2.0" else TINY_UNET
    torch.manual_seed(6)
    unet = build_unet_sd(ucfg)
    if stray:
        unet[stray] = torch.zeros(3)
    torch.save(unet, path / "unet.pt")
    torch.save(_new_vae_keys(build_vae_sd(TINY_VAE)), path / "vae.pt")
    torch.save(build_clip_sd(ccfg, seed=7), path / "text_encoder.pt")
    tok.save_assets(str(path / "tokenizer"))
    return ucfg, TINY_VAE, ccfg


@pytest.mark.parametrize("version", ["1.5", "2.0"])
def test_load_stable_diffusion_modules_matches_jax(tmp_path, rng, version):
    """The port's loader and the JAX package's on the same files: text
    embeddings, the SDS image gradient (2.0: conditioned on a depth map) at
    24 -> 32 (upsampled into the guidance) with t and the noise injected,
    and the decoder."""
    jcfgs = _write_sd_files(tmp_path, version)
    pcfgs = [cls(**dataclasses.asdict(c)) for cls, c in zip((sd.UNetConfig, sd.VAEConfig, sd.CLIPTextConfig), jcfgs)]
    jm = jsd.load_stable_diffusion_modules(str(tmp_path), version, unet_config=jcfgs[0], vae_config=jcfgs[1],
                                           clip_config=jcfgs[2], image_size=32)
    pm = sd.load_stable_diffusion_modules(str(tmp_path), version, unet_config=pcfgs[0], vae_config=pcfgs[1],
                                          clip_config=pcfgs[2], image_size=32, device="cpu")
    assert pm.use_depth == jm.use_depth == (version == "2.0")
    assert (pm.latent_scale, pm.image_size) == (jm.latent_scale, jm.image_size) == (2, 32)
    jg, pg = jdiff.SDSGuidance(jm), diffusion.SDSGuidance(pm)
    prompts = ["hulk style", "the front view of the body of the hulk"]
    jemb, pemb = jg.get_text_embeds(prompts[:1]), pg.get_text_embeds(prompts[:1])
    _close(pemb, jemb, MODULE_REL)
    _close(pm.text_encode(prompts), jm.text_encode(prompts), MODULE_REL)

    img = rng.random((1, 3, 24, 24)).astype(np.float32)
    noise = rng.normal(size=(1, 4, 16, 16)).astype(np.float32)
    depth = (rng.random((1, 1, 24, 24)) * 3 + 2).astype(np.float32) if version == "2.0" else None
    want = jax.jit(lambda e, i, d, n: jg.sds_image_grad(jax.random.PRNGKey(0), e, i, 100.0, pred_depth=d,
                                                        t_override=400, noise_override=n))(
        jemb, jnp.asarray(img), None if depth is None else jnp.asarray(depth), jnp.asarray(noise))
    got = pg.sds_image_grad(pemb, torch.from_numpy(img), 100.0,
                            pred_depth=None if depth is None else torch.from_numpy(depth), t_override=400,
                            noise_override=torch.from_numpy(noise))
    assert got.shape == img.shape and np.abs(np.asarray(want)).max() > 0
    _close(got, want, SDS_REL)
    lat = (rng.normal(size=(1, 4, 16, 16)) * 0.3).astype(np.float32)
    _close(pm.vae_decode(torch.from_numpy(lat)), jax.jit(jm.vae_decode)(jnp.asarray(lat)), MODULE_REL)


def test_loader_refuses_a_stray_unet_key(tmp_path):
    jcfgs = _write_sd_files(tmp_path, "1.5", stray="down_blocks.0.attentions.0.extra.bias")
    with pytest.raises(ValueError, match="unet.pt.*extra.bias"):
        sd.load_stable_diffusion_modules(str(tmp_path), unet_config=sd.UNetConfig(**dataclasses.asdict(jcfgs[0])),
                                         vae_config=P_VAE, device="cpu")


def test_stable_diffusion_configs():
    u, v, c = sd.stable_diffusion_configs("1.5")
    assert (u.block_out_channels, u.cross_attention_dim, u.attention_head_dim, u.in_channels) == (
        (320, 640, 1280, 1280), 768, 8, 4)
    assert (v.block_out_channels, c.vocab_size, c.hidden_size, c.num_layers) == ((128, 256, 512, 512), 49408, 768, 12)
    u, v, c = sd.stable_diffusion_configs("2.0")
    assert (u.in_channels, u.cross_attention_dim, u.attention_head_dim) == (5, 1024, (5, 10, 20, 20))
    assert (c.hidden_size, c.num_layers, c.num_heads) == (1024, 23, 16)
    with pytest.raises(ValueError, match="version"):
        sd.stable_diffusion_configs("3")


def test_random_modules_run_at_a_tiny_geometry(rng):
    """random_stable_diffusion_modules: the assembly without files (the
    full-width version runs on the card in chip_smoke.py)."""
    ccfg = dataclasses.replace(P_CLIP, vocab_size=600, hidden_size=12, max_len=16)
    mods = sd.random_stable_diffusion_modules(torch.Generator().manual_seed(0), configs=(P_UNET, P_VAE, ccfg),
                                              image_size=32)
    g = diffusion.SDSGuidance(mods)
    emb = g.get_text_embeds(["hulk"])
    grad = g.sds_image_grad(emb, torch.from_numpy(rng.random((1, 3, 16, 16)).astype(np.float32)),
                            generator=torch.Generator().manual_seed(1))
    assert emb.shape == (2, 16, 12) and torch.isfinite(grad).all() and grad.abs().max() > 0


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------


def test_tokenizer_ids_match_jax(tmp_path):
    tok, jt = clip_tokenizer.make_toy_tokenizer(), jtok.make_toy_tokenizer()
    assert tok.encoder == jt.encoder and tok.merges == jt.merges
    for p in PROMPTS + NON_ASCII:
        assert tok(p, max_length=77) == jt(p, max_length=77), p
        assert tok(p, max_length=16) == jt(p, max_length=16), p  # truncation keeps a final EOS
        assert tok.decode(tok.encode(p)) == jt.decode(jt.encode(p)), p
    assert tok(PROMPTS) == jt(PROMPTS)  # the batch at model_max_length 77
    # the assets: saved by the JAX package, read by the port; merges alone
    jt.save_assets(str(tmp_path))
    loaded = clip_tokenizer.CLIPTokenizer.from_pretrained(str(tmp_path))
    assert loaded.encoder == jt.encoder and loaded("hulk style") == jt("hulk style")
    (tmp_path / "vocab.json").unlink()
    assert clip_tokenizer.CLIPTokenizer.from_pretrained(str(tmp_path)).encoder == jt.encoder
    tok.save_assets(str(tmp_path / "port"))
    assert jtok.CLIPTokenizer.from_pretrained(str(tmp_path / "port")).encoder == jt.encoder


def test_word_split_matches_jax_on_every_assigned_code_point():
    """Every code point this Python's unicodedata assigns, between letters,
    a digit, a space and itself (in batches of 512)."""
    tok, jt = clip_tokenizer.make_toy_tokenizer(), jtok.make_toy_tokenizer()
    cps = [cp for cp in range(0x110000) if unicodedata.category(chr(cp)) not in ("Cn", "Cs")]
    for i in range(0, len(cps), 512):
        text = " ".join(f"a{chr(c)}1 x{chr(c)}{chr(c)}" for c in cps[i : i + 512])
        assert tok.words(text) == jt.pat.findall(jtok.whitespace_clean(jtok.basic_clean(text)).lower()), i
    # the named divergence: assigned in regex's newer tables only
    assert unicodedata.category("࢏") == "Cn" and jt.pat.findall("a࢏b") == ["a࢏b"]
    assert tok.words("a࢏b") == ["a", "࢏", "b"]


# ---------------------------------------------------------------------------
# resizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [(64, 512), (256, 512)])
def test_bilinear_upsampling_and_pullback_match_jax(rng, src, dst):
    """Phase A's 64^2 and 256^2 frames into SD's 512^2. The pullback sums
    (dst/src)^2 f32 products per input pixel: 4e-6 x max|ref| (measured
    6.0e-7 at 64 -> 512)."""
    img = rng.random((1, 3, src, src)).astype(np.float32)
    ct = rng.normal(size=(1, 3, dst, dst)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jax.image.resize(x, (1, 3, dst, dst), method="bilinear"), jnp.asarray(img))
    (want_g,) = vjp(jnp.asarray(ct))
    x = torch.from_numpy(img).requires_grad_()
    got = diffusion.resize_bilinear(x, dst)
    (got_g,) = torch.autograd.grad(got, x, torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)
    _close(got_g, want_g, 4e-6)


@pytest.mark.parametrize("src", [256, 64, 32])
def test_cubic_depth_resize_and_pullback_match_jax(rng, src):
    """The depth map into the 64^2 latent grid: 256 -> 64 (shrinking,
    antialiased), 64 -> 64 (the identity), 32 -> 64: 1e-6 x max|ref|
    (measured 4.4e-7)."""
    depth = (rng.random((1, 1, src, src)) * 5 + 2).astype(np.float32)
    ct = rng.normal(size=(1, 1, 64, 64)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jax.image.resize(x, (1, 1, 64, 64), method="cubic"), jnp.asarray(depth))
    (want_g,) = vjp(jnp.asarray(ct))
    x = torch.from_numpy(depth).requires_grad_()
    got = diffusion.resize_cubic(x, (64, 64))
    (got_g,) = torch.autograd.grad(got, x, torch.from_numpy(ct))
    _close(got.detach(), want, 1e-6)
    _close(got_g, want_g, 1e-6)
    if src == 64:
        assert torch.equal(got.detach(), x.detach())
