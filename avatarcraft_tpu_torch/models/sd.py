"""The conditional UNet2DCondition of Stable Diffusion as functions over a
parameter tree: port of the UNet part of the JAX package's models/sd.py
(``conv2d``, ``linear``, ``group_norm``, ``layer_norm``,
``timestep_embedding``, ``attention``, ``UNetConfig``, the resnet and
transformer blocks, ``init_unet_params``, ``unet_apply``). The toy guidance
runs it at a miniature config; the VAE, CLIP and the state-dict loaders come
with the Stable Diffusion weights (ROADMAP item 17).

The tree is the JAX package's, with two layout changes that
``unet_params_from_jax`` makes: activations are NCHW, so convolution
weights are OIHW (the JAX package's are HWIO); linear weights keep the
JAX package's [out, in]. Group norm uses min(groups, C) groups, as there.

Full f32 on the card: classifier-free guidance multiplies the UNet's
error by the guidance scale (100) before SDS clamps it, so the UNet refuses
TF32 matrix products (``torch.backends.cuda.matmul.allow_tf32``, off by
default) and runs its convolutions with cuDNN's TF32 switched off, the
flags restored after the call.

Attention is computed in plain PyTorch (two einsums and a softmax, as the
JAX package computes it); it replaces no Pallas kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

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


def unet_params_from_jax(tree, device="cuda") -> dict:
    """The JAX package's UNet tree, its leaves as numpy arrays, as the
    port's: f32 tensors on ``device``, HWIO convolution weights transposed
    to OIHW."""

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
