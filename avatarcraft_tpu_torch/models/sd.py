"""Stable Diffusion as functions over parameter trees: port of the JAX
package's models/sd.py. The conditional UNet2DCondition (``UNetConfig``,
``init_unet_params``, ``unet_apply``), the VAE encoder and decoder
(``VAEConfig``, ``vae_encode_apply``: the posterior mean x 0.18215;
``vae_decode_apply``), the CLIP text encoder (``CLIPTextConfig``,
``clip_text_apply``), the converters from diffusers / transformers state
dicts (``*_params_from_torch``, audited by ``KeyAudit``) and the loader
(``load_stable_diffusion_modules``: the state dicts converted, then
``assemble_stable_diffusion_modules``; ``random_stable_diffusion_modules``
assembles the same geometry from seeded random parameters). The toy
guidance runs the UNet at a miniature config.

The trees are the JAX package's, with two layout changes: activations are
NCHW, so convolution weights are OIHW (the JAX package's are HWIO;
``params_from_jax`` transposes them); linear weights keep the JAX
package's [out, in]. Group norm uses min(groups, C) groups, as there.
The converters read a state dict straight into this layout.

Full f32 on the card: classifier-free guidance multiplies the UNet's
error by the guidance scale (100) before SDS clamps it, so every module
here refuses TF32 matrix products (``torch.backends.cuda.matmul.allow_tf32``,
off by default) and runs its convolutions with cuDNN's TF32 switched off
(``full_f32``), the flags restored after the call.

Attention is computed in plain PyTorch (two einsums and a softmax, as the
JAX package computes it); it replaces no Pallas kernel.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from avatarcraft_tpu_torch.utils.checkpoint import map_leaves

# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def conv2d(p: dict, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """x: [B, C, H, W]; weights OIHW, explicit symmetric padding (also at
    stride 2, as the JAX package pads)."""
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=padding)


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].T + p["b"]


def group_norm(p: dict, x: torch.Tensor, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """x: [B, C, H, W]; min(groups, C) groups of consecutive channels."""
    return F.group_norm(x, min(groups, x.shape[1]), p["scale"], p["bias"], eps)


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       dtype=torch.float32) -> torch.Tensor:
    """Sinusoidal embedding, diffusers flip_sin_to_cos=True convention."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=dtype, device=t.device) / half)
    args = t[:, None].to(dtype) * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """q: [B, Nq, C], k/v: [B, Nk, C] -> [B, Nq, C]."""
    B, Nq, C = q.shape
    hd = C // heads

    def split(x):
        return x.reshape(B, -1, heads, hd).permute(0, 2, 1, 3)

    qh, kh, vh = split(q), split(k), split(v)
    attn = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(hd), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", attn, vh)
    return out.permute(0, 2, 1, 3).reshape(B, Nq, C)


# ---------------------------------------------------------------------------
# UNet blocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # head COUNT, int (SD1.5: 8 everywhere) or per-down-block tuple
    # (SD2: (5, 10, 20, 20), i.e. 64-dim heads)
    attention_head_dim: int | tuple = 8
    norm_groups: int = 32
    # which down blocks carry cross-attention (SD1.5: all but the last)
    attn_blocks: tuple = (True, True, True, False)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def heads_at(self, block_idx: int) -> int:
        ahd = self.attention_head_dim
        return ahd[block_idx] if isinstance(ahd, (tuple, list)) else ahd


def _resnet(p: dict, x: torch.Tensor, temb: torch.Tensor, groups: int) -> torch.Tensor:
    h = conv2d(p["conv1"], F.silu(group_norm(p["norm1"], x, groups)))
    h = h + linear(p["time_emb_proj"], F.silu(temb))[:, :, None, None]
    h = conv2d(p["conv2"], F.silu(group_norm(p["norm2"], h, groups)))
    if "shortcut" in p:
        x = conv2d(p["shortcut"], x, padding=0)
    return x + h


def _attn_apply(p: dict, x: torch.Tensor, ctx: torch.Tensor, heads: int) -> torch.Tensor:
    q = linear(p["to_q"], x)
    k = linear(p["to_k"], ctx)
    v = linear(p["to_v"], ctx)
    return linear(p["to_out"], attention(q, k, v, heads))


def _transformer(p: dict, x: torch.Tensor, ctx: torch.Tensor, heads: int, groups: int) -> torch.Tensor:
    B, C, H, W = x.shape
    res = x
    h = group_norm(p["norm"], x, groups)
    h = conv2d(p["proj_in"], h, padding=0).flatten(2).transpose(1, 2)  # [B, HW, C]
    n1 = layer_norm(p["norm1"], h)
    h = h + _attn_apply(p["attn1"], n1, n1, heads)
    h = h + _attn_apply(p["attn2"], layer_norm(p["norm2"], h), ctx, heads)
    a, gate = linear(p["ff_geglu"], layer_norm(p["norm3"], h)).chunk(2, dim=-1)
    # diffusers' GEGLU: the exact erf gelu (F.gelu's default)
    h = h + linear(p["ff_out"], a * F.gelu(gate))
    return conv2d(p["proj_out"], h.transpose(1, 2).reshape(B, C, H, W), padding=0) + res


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: the ``init_*``
    functions draw on their generator's device, so under this one they
    build a tree's structure and shapes without memory (what
    ``jax.eval_shape`` of an init gives)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _uniform(gen, shape, bound):
    return torch.rand(shape, generator=gen, device=gen.device) * (2 * bound) - bound


def _he_conv(gen, kh, kw, cin, cout):
    bound = 1.0 / math.sqrt(cin * kh * kw)
    return {"w": _uniform(gen, (cout, cin, kh, kw), bound), "b": _uniform(gen, (cout,), bound)}


def _he_linear(gen, cin, cout):
    bound = 1.0 / math.sqrt(cin)
    return {"w": _uniform(gen, (cout, cin), bound), "b": _uniform(gen, (cout,), bound)}


def _norm_init(c, device):
    return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)}


def _init_resnet(gen, cin, cout, temb_dim):
    p = {
        "norm1": _norm_init(cin, gen.device),
        "conv1": _he_conv(gen, 3, 3, cin, cout),
        "time_emb_proj": _he_linear(gen, temb_dim, cout),
        "norm2": _norm_init(cout, gen.device),
        "conv2": _he_conv(gen, 3, 3, cout, cout),
    }
    if cin != cout:
        p["shortcut"] = _he_conv(gen, 1, 1, cin, cout)
    return p


def _init_transformer(gen, c, ctx_dim):
    dev = gen.device

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def attn_init(ctx):
        return {
            "to_q": {"w": normal((c, c), c**-0.5), "b": torch.zeros(c, device=dev)},
            "to_k": {"w": normal((c, ctx), ctx**-0.5), "b": torch.zeros(c, device=dev)},
            "to_v": {"w": normal((c, ctx), ctx**-0.5), "b": torch.zeros(c, device=dev)},
            "to_out": _he_linear(gen, c, c),
        }

    return {
        "norm": _norm_init(c, dev),
        "proj_in": _he_conv(gen, 1, 1, c, c),
        "norm1": _norm_init(c, dev),
        "attn1": attn_init(c),
        "norm2": _norm_init(c, dev),
        "attn2": attn_init(ctx_dim),
        "norm3": _norm_init(c, dev),
        "ff_geglu": _he_linear(gen, c, c * 8),
        "ff_out": _he_linear(gen, c * 4, c),
        "proj_out": _he_conv(gen, 1, 1, c, c),
    }


def init_unet_params(generator: torch.Generator, cfg: UNetConfig) -> dict:
    """A random tree with the JAX package's structure and shapes (OIHW
    convolutions), drawn from ``generator`` on its device with the JAX
    package's distributions; the values are torch's."""
    ch = cfg.block_out_channels
    temb = cfg.time_embed_dim
    dev = generator.device
    params = {
        "conv_in": _he_conv(generator, 3, 3, cfg.in_channels, ch[0]),
        "time_mlp1": _he_linear(generator, ch[0], temb),
        "time_mlp2": _he_linear(generator, temb, temb),
        "down": [],
        "mid": {},
        "up": [],
        "norm_out": _norm_init(ch[0], dev),
        "conv_out": _he_conv(generator, 3, 3, ch[0], cfg.out_channels),
    }
    cin = ch[0]
    for i, cout in enumerate(ch):
        block = {"resnets": [], "attns": [], "down": None}
        for _ in range(cfg.layers_per_block):
            block["resnets"].append(_init_resnet(generator, cin, cout, temb))
            if cfg.attn_blocks[i]:
                block["attns"].append(_init_transformer(generator, cout, cfg.cross_attention_dim))
            cin = cout
        if i < len(ch) - 1:
            block["down"] = _he_conv(generator, 3, 3, cout, cout)
        params["down"].append(block)
    params["mid"] = {
        "res1": _init_resnet(generator, ch[-1], ch[-1], temb),
        "attn": _init_transformer(generator, ch[-1], cfg.cross_attention_dim),
        "res2": _init_resnet(generator, ch[-1], ch[-1], temb),
    }
    rev = list(reversed(ch))
    cin = ch[-1]
    for i, cout in enumerate(rev):
        attn_here = list(reversed(cfg.attn_blocks))[i]
        block = {"resnets": [], "attns": [], "up": None}
        for j in range(cfg.layers_per_block + 1):
            skip_ch = rev[min(i + 1, len(ch) - 1)] if j == cfg.layers_per_block else cout
            block["resnets"].append(_init_resnet(generator, cin + skip_ch, cout, temb))
            if attn_here:
                block["attns"].append(_init_transformer(generator, cout, cfg.cross_attention_dim))
            cin = cout
        if i < len(ch) - 1:
            block["up"] = _he_conv(generator, 3, 3, cout, cout)
        params["up"].append(block)
    return params


def params_from_jax(tree, device="cuda") -> dict:
    """A JAX package's tree of this module (the UNet, either VAE half,
    CLIP), its leaves as numpy arrays, as the port's: f32 tensors on
    ``device``, HWIO convolution weights transposed to OIHW."""

    def convert(a):
        a = np.array(a, np.float32)  # a writable copy
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return map_leaves(tree, convert)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def full_f32(device: torch.device):
    """Full f32 for the UNet on a CUDA device: refuse TF32 matrix products,
    switch cuDNN's TF32 convolutions off for the block (restored after)."""
    if device.type != "cuda":
        yield
        return
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the guidance UNet needs full f32 matrix products (classifier-free guidance "
            "multiplies its error by the guidance scale); torch.backends.cuda.matmul.allow_tf32 is on"
        )
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def unet_apply(
    params: dict,
    cfg: UNetConfig,
    latents: torch.Tensor,  # [B, C, h, w]
    t: torch.Tensor,  # [B]
    ctx: torch.Tensor,  # [B, L, D]
) -> torch.Tensor:
    """eps [B, out_channels, h, w] of the conditional UNet, in full f32."""
    with full_f32(latents.device):
        g = cfg.norm_groups
        temb = timestep_embedding(t, cfg.block_out_channels[0], dtype=latents.dtype)
        temb = linear(params["time_mlp2"], F.silu(linear(params["time_mlp1"], temb)))

        h = conv2d(params["conv_in"], latents)
        skips = [h]
        for i, block in enumerate(params["down"]):
            for j, res in enumerate(block["resnets"]):
                h = _resnet(res, h, temb, g)
                if block["attns"]:
                    h = _transformer(block["attns"][j], h, ctx, cfg.heads_at(i), g)
                skips.append(h)
            if block["down"] is not None:
                h = conv2d(block["down"], h, stride=2)
                skips.append(h)

        n_blocks = len(cfg.block_out_channels)
        h = _resnet(params["mid"]["res1"], h, temb, g)
        h = _transformer(params["mid"]["attn"], h, ctx, cfg.heads_at(n_blocks - 1), g)
        h = _resnet(params["mid"]["res2"], h, temb, g)

        for i, block in enumerate(params["up"]):
            for j, res in enumerate(block["resnets"]):
                h = torch.cat([h, skips.pop()], dim=1)
                h = _resnet(res, h, temb, g)
                if block["attns"]:
                    h = _transformer(block["attns"][j], h, ctx, cfg.heads_at(n_blocks - 1 - i), g)
            if block["up"] is not None:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = conv2d(block["up"], h)

        h = F.silu(group_norm(params["norm_out"], h, g))
        return conv2d(params["conv_out"], h)



# ---------------------------------------------------------------------------
# VAE (AutoencoderKL; the encoder's output is the posterior mean)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215  # reference: models/diffusion.py:310


def _init_vae_attn(gen, c):
    return {"norm": _norm_init(c, gen.device), "to_q": _he_linear(gen, c, c), "to_k": _he_linear(gen, c, c),
            "to_v": _he_linear(gen, c, c), "to_out": _he_linear(gen, c, c)}


def init_vae_encoder_params(generator: torch.Generator, cfg: VAEConfig) -> dict:
    """A random encoder tree with the JAX package's structure, shapes and
    distributions (its resnets carry a 4-wide time projection that a zero
    embedding reads, as there), drawn from ``generator`` on its device."""
    ch = cfg.block_out_channels
    params = {
        "conv_in": _he_conv(generator, 3, 3, cfg.in_channels, ch[0]),
        "down": [],
        "mid": {},
        "norm_out": _norm_init(ch[-1], generator.device),
        "conv_out": _he_conv(generator, 3, 3, ch[-1], 2 * cfg.latent_channels),
        "quant_conv": _he_conv(generator, 1, 1, 2 * cfg.latent_channels, 2 * cfg.latent_channels),
    }
    cin = ch[0]
    for i, cout in enumerate(ch):
        block = {"resnets": [], "down": None}
        for _ in range(cfg.layers_per_block):
            block["resnets"].append(_init_resnet(generator, cin, cout, 4))
            cin = cout
        if i < len(ch) - 1:
            block["down"] = _he_conv(generator, 3, 3, cout, cout)
        params["down"].append(block)
    params["mid"] = {
        "res1": _init_resnet(generator, ch[-1], ch[-1], 4),
        "attn": _init_vae_attn(generator, ch[-1]),
        "res2": _init_resnet(generator, ch[-1], ch[-1], 4),
    }
    return params


def init_vae_decoder_params(generator: torch.Generator, cfg: VAEConfig) -> dict:
    """A random decoder tree (post_quant_conv included), as
    ``init_vae_encoder_params`` draws the encoder's."""
    ch = tuple(reversed(cfg.block_out_channels))
    params = {
        "post_quant_conv": _he_conv(generator, 1, 1, cfg.latent_channels, cfg.latent_channels),
        "conv_in": _he_conv(generator, 3, 3, cfg.latent_channels, ch[0]),
        "mid": {
            "res1": _init_resnet(generator, ch[0], ch[0], 4),
            "attn": _init_vae_attn(generator, ch[0]),
            "res2": _init_resnet(generator, ch[0], ch[0], 4),
        },
        "up": [],
        "norm_out": _norm_init(ch[-1], generator.device),
        "conv_out": _he_conv(generator, 3, 3, ch[-1], cfg.in_channels),
    }
    cin = ch[0]
    for i, cout in enumerate(ch):
        block = {"resnets": [], "up": None}
        for _ in range(cfg.layers_per_block + 1):
            block["resnets"].append(_init_resnet(generator, cin, cout, 4))
            cin = cout
        if i < len(ch) - 1:
            block["up"] = _he_conv(generator, 3, 3, cout, cout)
        params["up"].append(block)
    return params


def _vae_resnet(p: dict, x: torch.Tensor, groups: int) -> torch.Tensor:
    """The shared resnet with a zero time embedding (its projection adds
    the bias alone)."""
    zero_t = torch.zeros((x.shape[0], p["time_emb_proj"]["w"].shape[1]), dtype=x.dtype, device=x.device)
    return _resnet(p, x, zero_t, groups)


def _vae_mid_attention(p: dict, h: torch.Tensor, groups: int) -> torch.Tensor:
    """The mid block's single-head self-attention over the H x W positions,
    with its residual."""
    B, C, H, W = h.shape
    a = group_norm(p["norm"], h, groups).flatten(2).transpose(1, 2)  # [B, HW, C]
    a = attention(linear(p["to_q"], a), linear(p["to_k"], a), linear(p["to_v"], a), heads=1)
    return h + linear(p["to_out"], a).transpose(1, 2).reshape(B, C, H, W)


def vae_encode_apply(params: dict, cfg: VAEConfig, images: torch.Tensor) -> torch.Tensor:
    """images [B, 3, H, W] in [0, 1] -> the scaled posterior mean [B, 4,
    H/f, W/f] (reference: models/diffusion.py:304-312 samples the
    posterior; the mean keeps SDS deterministic), in full f32."""
    with full_f32(images.device):
        g = cfg.norm_groups
        h = conv2d(params["conv_in"], images * 2.0 - 1.0)
        for block in params["down"]:
            for res in block["resnets"]:
                h = _vae_resnet(res, h, g)
            if block["down"] is not None:
                # diffusers pads the stride-2 convolution asymmetrically:
                # one row below and one column right (F.pad: last dim first)
                h = conv2d(block["down"], F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
        h = _vae_resnet(params["mid"]["res1"], h, g)
        h = _vae_mid_attention(params["mid"]["attn"], h, g)
        h = _vae_resnet(params["mid"]["res2"], h, g)
        h = conv2d(params["conv_out"], F.silu(group_norm(params["norm_out"], h, g)))
        mean, _logvar = conv2d(params["quant_conv"], h, padding=0).chunk(2, dim=1)
        return mean * cfg.scaling_factor


def vae_decode_apply(params: dict, cfg: VAEConfig, latents: torch.Tensor) -> torch.Tensor:
    """latents [B, 4, h, w] (scaled) -> images [B, 3, H, W] clipped to
    [0, 1] (reference: models/diffusion.py:292-302), in full f32."""
    with full_f32(latents.device):
        g = cfg.norm_groups
        h = conv2d(params["post_quant_conv"], latents / cfg.scaling_factor, padding=0)
        h = conv2d(params["conv_in"], h)
        h = _vae_resnet(params["mid"]["res1"], h, g)
        h = _vae_mid_attention(params["mid"]["attn"], h, g)
        h = _vae_resnet(params["mid"]["res2"], h, g)
        for block in params["up"]:
            for res in block["resnets"]:
                h = _vae_resnet(res, h, g)
            if block["up"] is not None:
                h = conv2d(block["up"], F.interpolate(h, scale_factor=2, mode="nearest"))
        h = conv2d(params["conv_out"], F.silu(group_norm(params["norm_out"], h, g)))
        return torch.clamp((h + 1.0) / 2.0, 0.0, 1.0)


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_len: int = 77


def init_clip_text_params(generator: torch.Generator, cfg: CLIPTextConfig) -> dict:
    """A random CLIP tree with the JAX package's structure, shapes and
    distributions, drawn from ``generator`` on its device."""
    d, dev = cfg.hidden_size, generator.device

    def ln():
        return {"scale": torch.ones(d, device=dev), "bias": torch.zeros(d, device=dev)}

    params = {
        "tok_emb": torch.randn((cfg.vocab_size, d), generator=generator, device=dev) * 0.02,
        "pos_emb": torch.randn((cfg.max_len, d), generator=generator, device=dev) * 0.01,
        "layers": [],
        "final_norm": ln(),
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "ln1": ln(),
            "q": _he_linear(generator, d, d),
            "k": _he_linear(generator, d, d),
            "v": _he_linear(generator, d, d),
            "out": _he_linear(generator, d, d),
            "ln2": ln(),
            "fc1": _he_linear(generator, d, d * 4),
            "fc2": _he_linear(generator, d * 4, d),
        })
    return params


def clip_text_apply(params: dict, cfg: CLIPTextConfig, input_ids: torch.Tensor) -> torch.Tensor:
    """input_ids [B, L] -> the last hidden state [B, L, D] of the causal
    CLIP text transformer, in full f32."""
    with full_f32(input_ids.device):
        B, L = input_ids.shape
        hd = cfg.hidden_size // cfg.num_heads
        h = params["tok_emb"][input_ids] + params["pos_emb"][:L]
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=input_ids.device))

        def split(x):
            return x.reshape(B, L, cfg.num_heads, hd).permute(0, 2, 1, 3)

        for layer in params["layers"]:
            a_in = layer_norm(layer["ln1"], h)
            q, k, v = linear(layer["q"], a_in), linear(layer["k"], a_in), linear(layer["v"], a_in)
            attn = torch.einsum("bhqd,bhkd->bhqk", split(q), split(k)) / math.sqrt(hd)
            # -1e9, not -inf: the masked softmax is the JAX package's
            attn = torch.softmax(torch.where(causal, attn, torch.tensor(-1e9, dtype=attn.dtype, device=attn.device)),
                                 dim=-1)
            o = torch.einsum("bhqk,bhkd->bhqd", attn, split(v)).permute(0, 2, 1, 3).reshape(B, L, -1)
            h = h + linear(layer["out"], o)
            f = linear(layer["fc1"], layer_norm(layer["ln2"], h))
            h = h + linear(layer["fc2"], f * torch.sigmoid(1.702 * f))  # CLIP's quick GELU
        return layer_norm(params["final_norm"], h)


# ---------------------------------------------------------------------------
# State-dict conversion
# ---------------------------------------------------------------------------

# parts of keys that carry no learned weight and may go unconsumed
IGNORABLE_KEY_PARTS = ("position_ids", "num_batches_tracked", "model_ema", "logit_scale")


class KeyAudit(dict):
    """State-dict wrapper that records which keys a converter consumed:
    ``consumed`` holds every fully prefixed key the converter read
    (``__getitem__``) or found (``__contains__``), across the sub-dicts
    ``_strip_prefix`` makes. ``refuse_unconsumed`` raises on the keys no
    converter took (a layout or config mismatch would otherwise load
    partly random weights)."""

    def __init__(self, data, consumed: set | None = None, prefix: str = ""):
        super().__init__(data)
        self.consumed = consumed if consumed is not None else set()
        self.prefix = prefix

    def __missing__(self, k):
        raise KeyError(self.prefix + k)

    def __getitem__(self, k):
        v = super().__getitem__(k)
        self.consumed.add(self.prefix + k)
        return v

    def __contains__(self, k):
        if super().__contains__(k):
            self.consumed.add(self.prefix + k)
            return True
        return False

    def unconsumed(self) -> list[str]:
        """The keys no converter took, less IGNORABLE_KEY_PARTS."""
        return sorted(self.prefix + k for k in self.keys() if self.prefix + k not in self.consumed
                      and not any(part in k for part in IGNORABLE_KEY_PARTS))

    def refuse_unconsumed(self, what: str) -> None:
        stray = self.unconsumed()
        if stray:
            raise ValueError(f"{what}: {len(stray)} keys no converter reads (a layout or config mismatch), "
                             f"e.g. {stray[:5]}")


_KEEP_SOURCE_DTYPES = contextvars.ContextVar("keep_source_dtypes", default=False)


@contextlib.contextmanager
def source_dtypes():
    """Within the block the converters keep each state-dict value's dtype
    (float64 narrowed to float32), as the JAX package's converters keep
    numpy's; outside it every converted leaf is float32. The leaves a
    converter makes up (a missing bias, the VAE's time projection) are
    float32 either way."""
    token = _KEEP_SOURCE_DTYPES.set(True)
    try:
        yield
    finally:
        _KEEP_SOURCE_DTYPES.reset(token)


def _tensor(v, device) -> torch.Tensor:
    """A state-dict value (torch tensor or numpy array) as a copy on
    ``device``: float32, or its own dtype within ``source_dtypes``."""
    keep = _KEEP_SOURCE_DTYPES.get()
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v) if keep else np.array(v, np.float32))
    dtype = (torch.float32 if v.dtype == torch.float64 else v.dtype) if keep else torch.float32
    return v.to(device=device, dtype=dtype, copy=True)


def _t_conv(sd, prefix, device):
    """A torch convolution: OIHW as it is."""
    return {"w": _tensor(sd[f"{prefix}.weight"], device), "b": _tensor(sd[f"{prefix}.bias"], device)}


def _t_linear(sd, prefix, device, bias=True):
    w = _tensor(sd[f"{prefix}.weight"], device)
    b = (_tensor(sd[f"{prefix}.bias"], device) if bias and f"{prefix}.bias" in sd
         else torch.zeros(w.shape[0], device=device))
    return {"w": w, "b": b}


def _t_norm(sd, prefix, device):
    return {"scale": _tensor(sd[f"{prefix}.weight"], device), "bias": _tensor(sd[f"{prefix}.bias"], device)}


def unet_params_from_torch(sd: dict, cfg: UNetConfig = UNetConfig(), device="cuda") -> dict:
    """A diffusers UNet2DConditionModel state dict (torch tensors or numpy
    arrays; diffusers >= 0.14 keys) as the port's tree on ``device``."""

    def resnet(prefix):
        p = {
            "norm1": _t_norm(sd, f"{prefix}.norm1", device),
            "conv1": _t_conv(sd, f"{prefix}.conv1", device),
            "time_emb_proj": _t_linear(sd, f"{prefix}.time_emb_proj", device),
            "norm2": _t_norm(sd, f"{prefix}.norm2", device),
            "conv2": _t_conv(sd, f"{prefix}.conv2", device),
        }
        if f"{prefix}.conv_shortcut.weight" in sd:
            p["shortcut"] = _t_conv(sd, f"{prefix}.conv_shortcut", device)
        return p

    def attn(prefix):
        return {
            "to_q": _t_linear(sd, f"{prefix}.to_q", device, bias=False),
            "to_k": _t_linear(sd, f"{prefix}.to_k", device, bias=False),
            "to_v": _t_linear(sd, f"{prefix}.to_v", device, bias=False),
            "to_out": _t_linear(sd, f"{prefix}.to_out.0", device),
        }

    def transformer(prefix):
        blk = f"{prefix}.transformer_blocks.0"
        return {
            "norm": _t_norm(sd, f"{prefix}.norm", device),
            "proj_in": _t_conv(sd, f"{prefix}.proj_in", device),
            "norm1": _t_norm(sd, f"{blk}.norm1", device),
            "attn1": attn(f"{blk}.attn1"),
            "norm2": _t_norm(sd, f"{blk}.norm2", device),
            "attn2": attn(f"{blk}.attn2"),
            "norm3": _t_norm(sd, f"{blk}.norm3", device),
            "ff_geglu": _t_linear(sd, f"{blk}.ff.net.0.proj", device),
            "ff_out": _t_linear(sd, f"{blk}.ff.net.2", device),
            "proj_out": _t_conv(sd, f"{prefix}.proj_out", device),
        }

    params = {
        "conv_in": _t_conv(sd, "conv_in", device),
        "time_mlp1": _t_linear(sd, "time_embedding.linear_1", device),
        "time_mlp2": _t_linear(sd, "time_embedding.linear_2", device),
        "norm_out": _t_norm(sd, "conv_norm_out", device),
        "conv_out": _t_conv(sd, "conv_out", device),
        "down": [],
        "up": [],
        "mid": {
            "res1": resnet("mid_block.resnets.0"),
            "attn": transformer("mid_block.attentions.0"),
            "res2": resnet("mid_block.resnets.1"),
        },
    }
    for i in range(len(cfg.block_out_channels)):
        block = {"resnets": [], "attns": [], "down": None}
        for j in range(cfg.layers_per_block):
            block["resnets"].append(resnet(f"down_blocks.{i}.resnets.{j}"))
            if cfg.attn_blocks[i]:
                block["attns"].append(transformer(f"down_blocks.{i}.attentions.{j}"))
        if f"down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            block["down"] = _t_conv(sd, f"down_blocks.{i}.downsamplers.0.conv", device)
        params["down"].append(block)
    for i in range(len(cfg.block_out_channels)):
        attn_here = list(reversed(cfg.attn_blocks))[i]
        block = {"resnets": [], "attns": [], "up": None}
        for j in range(cfg.layers_per_block + 1):
            block["resnets"].append(resnet(f"up_blocks.{i}.resnets.{j}"))
            if attn_here:
                block["attns"].append(transformer(f"up_blocks.{i}.attentions.{j}"))
        if f"up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            block["up"] = _t_conv(sd, f"up_blocks.{i}.upsamplers.0.conv", device)
        params["up"].append(block)
    return params


def _strip_prefix(sd: dict, prefix: str) -> dict:
    """The sub-dict of keys under ``prefix`` (removed); {} if none. A
    KeyAudit stays one, sharing its record of consumed keys."""
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if isinstance(sd, KeyAudit) and out:
        return KeyAudit(out, sd.consumed, sd.prefix + prefix)
    return out


def _t_attn_block(sd, prefix, device):
    """The VAE's mid attention in either diffusers key era: <= 0.16
    AttentionBlock (query/key/value/proj_attn) or >= 0.17 Attention
    (to_q/to_k/to_v/to_out.0)."""
    if f"{prefix}.query.weight" in sd:
        names = {"q": "query", "k": "key", "v": "value", "o": "proj_attn"}
    else:
        names = {"q": "to_q", "k": "to_k", "v": "to_v", "o": "to_out.0"}
    return {
        "norm": _t_norm(sd, f"{prefix}.group_norm", device),
        "to_q": _t_linear(sd, f"{prefix}.{names['q']}", device),
        "to_k": _t_linear(sd, f"{prefix}.{names['k']}", device),
        "to_v": _t_linear(sd, f"{prefix}.{names['v']}", device),
        "to_out": _t_linear(sd, f"{prefix}.{names['o']}", device),
    }


def _t_vae_resnet(sd, prefix, device, temb_dim: int = 4):
    """diffusers' VAE resnets have no time embedding; the shared resnet
    reads a zero projection (silu(0) @ 0 + 0 = 0)."""
    cout = sd[f"{prefix}.conv2.bias"].shape[0]
    p = {
        "norm1": _t_norm(sd, f"{prefix}.norm1", device),
        "conv1": _t_conv(sd, f"{prefix}.conv1", device),
        "time_emb_proj": {"w": torch.zeros((cout, temb_dim), device=device), "b": torch.zeros(cout, device=device)},
        "norm2": _t_norm(sd, f"{prefix}.norm2", device),
        "conv2": _t_conv(sd, f"{prefix}.conv2", device),
    }
    if f"{prefix}.conv_shortcut.weight" in sd:
        p["shortcut"] = _t_conv(sd, f"{prefix}.conv_shortcut", device)
    return p


def vae_encoder_params_from_torch(sd: dict, cfg: VAEConfig = VAEConfig(), device="cuda") -> dict:
    """A diffusers AutoencoderKL state dict (the whole model or the encoder
    half: ``encoder.``-prefixed keys and the top-level ``quant_conv``) as
    the port's encoder tree on ``device``."""
    enc = _strip_prefix(sd, "encoder.") or sd
    params = {
        "conv_in": _t_conv(enc, "conv_in", device),
        "down": [],
        "mid": {
            "res1": _t_vae_resnet(enc, "mid_block.resnets.0", device),
            "attn": _t_attn_block(enc, "mid_block.attentions.0", device),
            "res2": _t_vae_resnet(enc, "mid_block.resnets.1", device),
        },
        "norm_out": _t_norm(enc, "conv_norm_out", device),
        "conv_out": _t_conv(enc, "conv_out", device),
        "quant_conv": _t_conv(sd if "quant_conv.weight" in sd else enc, "quant_conv", device),
    }
    for i in range(len(cfg.block_out_channels)):
        block = {"resnets": [], "down": None}
        for j in range(cfg.layers_per_block):
            block["resnets"].append(_t_vae_resnet(enc, f"down_blocks.{i}.resnets.{j}", device))
        if f"down_blocks.{i}.downsamplers.0.conv.weight" in enc:
            block["down"] = _t_conv(enc, f"down_blocks.{i}.downsamplers.0.conv", device)
        params["down"].append(block)
    return params


def vae_decoder_params_from_torch(sd: dict, cfg: VAEConfig = VAEConfig(), device="cuda") -> dict:
    """The decoder half and post_quant_conv of a diffusers AutoencoderKL
    state dict as the port's decoder tree on ``device``."""
    dec = _strip_prefix(sd, "decoder.") or sd
    params = {
        "post_quant_conv": _t_conv(sd if "post_quant_conv.weight" in sd else dec, "post_quant_conv", device),
        "conv_in": _t_conv(dec, "conv_in", device),
        "mid": {
            "res1": _t_vae_resnet(dec, "mid_block.resnets.0", device),
            "attn": _t_attn_block(dec, "mid_block.attentions.0", device),
            "res2": _t_vae_resnet(dec, "mid_block.resnets.1", device),
        },
        "up": [],
        "norm_out": _t_norm(dec, "conv_norm_out", device),
        "conv_out": _t_conv(dec, "conv_out", device),
    }
    for i in range(len(cfg.block_out_channels)):
        block = {"resnets": [], "up": None}
        for j in range(cfg.layers_per_block + 1):
            block["resnets"].append(_t_vae_resnet(dec, f"up_blocks.{i}.resnets.{j}", device))
        if f"up_blocks.{i}.upsamplers.0.conv.weight" in dec:
            block["up"] = _t_conv(dec, f"up_blocks.{i}.upsamplers.0.conv", device)
        params["up"].append(block)
    return params


def clip_text_params_from_torch(sd: dict, cfg: CLIPTextConfig = CLIPTextConfig(), device="cuda") -> dict:
    """A transformers CLIPTextModel state dict as the port's tree on
    ``device``."""
    tm = _strip_prefix(sd, "text_model.") or sd
    params = {
        "tok_emb": _tensor(tm["embeddings.token_embedding.weight"], device),
        "pos_emb": _tensor(tm["embeddings.position_embedding.weight"], device),
        "layers": [],
        "final_norm": _t_norm(tm, "final_layer_norm", device),
    }
    for i in range(cfg.num_layers):
        pre = f"encoder.layers.{i}"
        params["layers"].append({
            "ln1": _t_norm(tm, f"{pre}.layer_norm1", device),
            "q": _t_linear(tm, f"{pre}.self_attn.q_proj", device),
            "k": _t_linear(tm, f"{pre}.self_attn.k_proj", device),
            "v": _t_linear(tm, f"{pre}.self_attn.v_proj", device),
            "out": _t_linear(tm, f"{pre}.self_attn.out_proj", device),
            "ln2": _t_norm(tm, f"{pre}.layer_norm2", device),
            "fc1": _t_linear(tm, f"{pre}.mlp.fc1", device),
            "fc2": _t_linear(tm, f"{pre}.mlp.fc2", device),
        })
    return params


# ---------------------------------------------------------------------------
# Loading and assembly
# ---------------------------------------------------------------------------


def stable_diffusion_configs(version: str = "1.5") -> tuple[UNetConfig, VAEConfig, CLIPTextConfig]:
    """The published geometry of SD 1.5 or of SD 2.0-depth (in_channels 5,
    1024-wide context, heads (5, 10, 20, 20), CLIP 1024 wide, 23 layers, 16
    heads; reference: models/diffusion.py:44-49)."""
    if version == "2.0":
        return (UNetConfig(in_channels=5, cross_attention_dim=1024, attention_head_dim=(5, 10, 20, 20)),
                VAEConfig(), CLIPTextConfig(hidden_size=1024, num_layers=23, num_heads=16))
    if version != "1.5":
        raise ValueError(f"unknown Stable Diffusion version {version!r} (1.5 or 2.0)")
    return UNetConfig(), VAEConfig(), CLIPTextConfig()


def _load_state_dict(path: str) -> dict:
    """A state dict saved with torch.save (tensors only: weights_only);
    a {'state_dict': ...} container is unwrapped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return dict(sd)


def assemble_stable_diffusion_modules(
    unet_params: dict,
    vae_encoder: dict,
    vae_decoder: dict | None,
    clip_params: dict,
    tokenizer,
    configs: tuple[UNetConfig, VAEConfig, CLIPTextConfig],
    image_size: int = 512,
    use_depth: bool = False,
):
    """GuidanceModules over the port's parameter trees (all on one device):
    the UNet, the VAE encoder (and decoder, for txt2img) and CLIP behind
    ``tokenizer``."""
    from avatarcraft_tpu_torch.models.diffusion import GuidanceModules

    ucfg, vcfg, tcfg = configs
    device = clip_params["tok_emb"].device

    def text_encode(prompts: list[str]) -> torch.Tensor:
        ids = torch.as_tensor(tokenizer(prompts, max_length=tcfg.max_len), dtype=torch.int64, device=device)
        return clip_text_apply(clip_params, tcfg, ids)

    return GuidanceModules(
        unet=lambda l, t, c: unet_apply(unet_params, ucfg, l, t, c),
        vae_encode=lambda im: vae_encode_apply(vae_encoder, vcfg, im),
        text_encode=text_encode,
        latent_scale=2 ** (len(vcfg.block_out_channels) - 1),
        latent_channels=vcfg.latent_channels,
        image_size=image_size,
        vae_decode=(lambda lat: vae_decode_apply(vae_decoder, vcfg, lat)) if vae_decoder is not None else None,
        tokenizer=tokenizer,
        configs={"unet": ucfg, "vae": vcfg, "clip": tcfg},
        use_depth=use_depth,
    )


def load_stable_diffusion_modules(
    path: str,
    version: str = "1.5",
    *,
    unet_config: UNetConfig | None = None,
    vae_config: VAEConfig | None = None,
    clip_config: CLIPTextConfig | None = None,
    image_size: int = 512,
    device="cuda",
):
    """GuidanceModules from a directory of torch state dicts (reference:
    models/diffusion.py:53-64 loads them from the HuggingFace hub):

        <path>/unet.pt              diffusers UNet2DConditionModel
        <path>/vae.pt               diffusers AutoencoderKL
        <path>/text_encoder.pt      transformers CLIPTextModel
        <path>/tokenizer/merges.txt (+ optional vocab.json)

    ``version`` '2.0' takes SD 2.0-depth's geometry and conditions the UNet
    on depth; the configs override the version's. Every key of each file
    must be read by its converter (``KeyAudit``), apart from buffers that
    carry no weight; the VAE's decoder is converted when the file has one."""
    from avatarcraft_tpu_torch.models.clip_tokenizer import CLIPTokenizer

    ucfg, vcfg, tcfg = stable_diffusion_configs(version)
    configs = (unet_config or ucfg, vae_config or vcfg, clip_config or tcfg)
    unet_sd = KeyAudit(_load_state_dict(os.path.join(path, "unet.pt")))
    unet = unet_params_from_torch(unet_sd, configs[0], device)
    unet_sd.refuse_unconsumed("unet.pt")
    vae_sd = KeyAudit(_load_state_dict(os.path.join(path, "vae.pt")))
    encoder = vae_encoder_params_from_torch(vae_sd, configs[1], device)
    has_decoder = any(k.startswith("decoder.") for k in vae_sd.keys())
    decoder = vae_decoder_params_from_torch(vae_sd, configs[1], device) if has_decoder else None
    vae_sd.refuse_unconsumed("vae.pt")
    clip_sd = KeyAudit(_load_state_dict(os.path.join(path, "text_encoder.pt")))
    clip = clip_text_params_from_torch(clip_sd, configs[2], device)
    clip_sd.refuse_unconsumed("text_encoder.pt")
    tokenizer = CLIPTokenizer.from_pretrained(os.path.join(path, "tokenizer"))
    return assemble_stable_diffusion_modules(unet, encoder, decoder, clip, tokenizer, configs, image_size,
                                             use_depth=version == "2.0")


def random_stable_diffusion_modules(generator: torch.Generator, version: str = "1.5", *,
                                    configs: tuple | None = None, image_size: int = 512):
    """GuidanceModules of ``version``'s geometry (or ``configs``) from
    parameters drawn from ``generator`` on its device, behind the toy
    tokenizer: the full-width modules without weight files."""
    from avatarcraft_tpu_torch.models.clip_tokenizer import make_toy_tokenizer

    ucfg, vcfg, tcfg = configs or stable_diffusion_configs(version)
    return assemble_stable_diffusion_modules(
        init_unet_params(generator, ucfg), init_vae_encoder_params(generator, vcfg),
        init_vae_decoder_params(generator, vcfg), init_clip_text_params(generator, tcfg), make_toy_tokenizer(),
        (ucfg, vcfg, tcfg), image_size, use_depth=version == "2.0")
