"""The in-environment trained SDS guidance (the "toy" conditional denoiser):
port of the JAX package's models/toy_guidance.py (the style palettes and
targets ``style_map`` / ``apply_style``, ``style_index``,
``ToyGuidanceConfig``, ``make_toy_modules``, the DDPM trainer and the
checkpoint's save and load).

A pixel-space conditional UNet (``models/sd.py`` at a miniature config)
DDPM-trained on procedural style targets; conditioning is one fixed
embedding per style keyword, the last row the null embedding of the empty
prompt (the classifier-free pair). View-augmented prompts ("front view of
the body of the lava") resolve to the style keyword they contain.

Weights: the JAX package's orbax checkpoint ``artifacts/toy_guidance/
params/``, read without orbax (``utils/checkpoint.py::load_checkpoint``),
as the JAX package's ``load_toy_guidance`` reads it. Beside it,
``params_torch.npz`` holds the ``style_embeddings`` array, which the JAX
package draws from ``jax.random.PRNGKey(seed)`` and which the port cannot
draw itself, and the same leaves under ``params/<path>`` (the JAX tree's
keys joined by "/", HWIO convolutions), which the tests hold bitwise
against the orbax directory. Run ``python tests/test_torch_toy_guidance.py``
to regenerate it (it needs the JAX package and orbax).
``save_toy_guidance`` writes the JAX package's directory (``params/``
through ``utils/checkpoint.py::save_checkpoint``, and ``config.json``)
and an npz of the style embeddings alone; ``load_toy_guidance`` reads the
leaves from an npz only where ``params/`` is missing.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from avatarcraft_tpu_torch.models.diffusion import DiffusionSchedule, GuidanceModules
from avatarcraft_tpu_torch.models.sd import UNetConfig, full_f32, params_from_jax, unet_apply
from avatarcraft_tpu_torch.utils.checkpoint import load_checkpoint, map_leaves, save_checkpoint

# luminance -> color control points (evenly spaced in [0, 1])
STYLE_PALETTES: dict[str, tuple] = {
    "lava": ((0.10, 0.00, 0.00), (0.62, 0.05, 0.00),
             (0.95, 0.45, 0.05), (1.00, 0.95, 0.30)),
    "emerald": ((0.00, 0.05, 0.02), (0.02, 0.35, 0.15),
                (0.10, 0.70, 0.35), (0.80, 1.00, 0.85)),
    "porcelain": ((0.20, 0.25, 0.35), (0.55, 0.60, 0.70),
                  (0.85, 0.88, 0.95), (1.00, 1.00, 1.00)),
}
# the style keywords of the committed checkpoint, in its order
STYLES: tuple = tuple(STYLE_PALETTES)
WEIGHTS_FILE = "params_torch.npz"
# the config.json keys, in the JAX package's order
CONFIG_KEYS = ("image_size", "emb_dim", "seq_len", "block_out_channels", "layers_per_block",
               "attention_head_dim", "norm_groups", "attn_blocks", "styles", "seed")


def style_index(prompt: str) -> int:
    """Style id carried by a (possibly view-augmented) prompt; -1 = uncond.
    Matches by keyword containment (reference: render_utils.py:80-90 adds
    the view prefixes)."""
    for i, name in enumerate(STYLES):
        if name in prompt:
            return i
    return -1


def style_map(rgb: torch.Tensor, style: int | str) -> torch.Tensor:
    """Palette mapping: [..., 3] colors -> [..., 3] palette colors by
    luminance (piecewise-linear over the style's control points)."""
    if isinstance(style, str):
        style = STYLES.index(style)
    pal = torch.tensor(list(STYLE_PALETTES.values())[style], dtype=rgb.dtype, device=rgb.device)  # [K, 3]
    lum = torch.clamp(0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2], 0.0, 1.0)
    k = pal.shape[0]
    x = lum * (k - 1)
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, k - 2)
    f = (x - i0)[..., None]
    return pal[i0] * (1.0 - f) + pal[i0 + 1] * f


def apply_style(rgb: torch.Tensor, alpha: torch.Tensor, style: int | str) -> torch.Tensor:
    """The procedural target: the foreground's luminance mapped through the
    style's palette, the background (1 - alpha) left as it is.

    rgb:   [..., 3] composited render colors in [0, 1]
    alpha: [...] foreground coverage (the render's weight_sum)
    """
    return style_map(rgb, style) * alpha[..., None] + rgb * (1.0 - alpha[..., None])


@dataclasses.dataclass(frozen=True)
class ToyGuidanceConfig:
    image_size: int = 64
    emb_dim: int = 24
    seq_len: int = 4
    block_out_channels: tuple = (32, 64, 96)
    layers_per_block: int = 1
    attention_head_dim: int = 4
    norm_groups: int = 8
    attn_blocks: tuple = (False, True, True)
    styles: tuple = STYLES
    seed: int = 1234

    @property
    def unet(self) -> UNetConfig:
        return UNetConfig(
            in_channels=3,
            out_channels=3,
            block_out_channels=self.block_out_channels,
            layers_per_block=self.layers_per_block,
            cross_attention_dim=self.emb_dim,
            attention_head_dim=self.attention_head_dim,
            norm_groups=self.norm_groups,
            attn_blocks=self.attn_blocks,
        )


def make_toy_modules(params: dict, cfg: ToyGuidanceConfig, embeddings: torch.Tensor) -> GuidanceModules:
    """GuidanceModules of the toy denoiser: ``params`` the port's UNet tree,
    ``embeddings`` [n_styles + 1, L, D] (the last row the null embedding),
    both on the device the guidance runs on."""

    def text_encode(prompts):
        idx = [style_index(p) if p else -1 for p in prompts]
        # -1 (uncond/unknown) -> the null row (last)
        rows = torch.as_tensor([i if i >= 0 else len(cfg.styles) for i in idx], device=embeddings.device)
        return embeddings[rows]

    return GuidanceModules(
        unet=lambda l, t, c: unet_apply(params, cfg.unet, l, t, c),
        # pixel-space diffusion: the "latent" IS the [-1,1]-scaled image,
        # so the SDS pullback runs through this scaling and the resize
        vae_encode=lambda im: im * 2.0 - 1.0,
        text_encode=text_encode,
        latent_scale=1,
        latent_channels=3,
        image_size=cfg.image_size,
        vae_decode=lambda lat: torch.clamp((lat + 1.0) / 2.0, 0.0, 1.0),
        configs={"toy": cfg},
    )


def read_config(path: str) -> ToyGuidanceConfig:
    """The ToyGuidanceConfig of a checkpoint directory's config.json."""
    with open(os.path.join(path, "config.json")) as fp:
        d = json.load(fp)
    return ToyGuidanceConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def _unflatten(flat: dict) -> dict:
    """{"a/0/b": x, ...} -> {"a": [{"b": x}], ...}: dicts whose keys are all
    indices become lists."""
    root: dict = {}
    for key, value in flat.items():
        node = root
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def load_toy_guidance(path: str, device="cuda"):
    """(params, ToyGuidanceConfig, style embeddings) of a toy-guidance
    checkpoint directory, the tensors on ``device``: config.json, the
    leaves of the orbax directory ``params/`` as the JAX package's
    load_toy_guidance reads them (or, where there is none, those of
    params_torch.npz, which ``save_toy_guidance`` writes), and the style
    embeddings of params_torch.npz. Blocks without attention or without a
    resampling conv hold the JAX tree's empty list and None."""
    cfg = read_config(path)
    orbax_dir = os.path.join(path, "params")
    with np.load(os.path.join(path, WEIGHTS_FILE)) as z:
        embeddings = torch.from_numpy(np.array(z["style_embeddings"], np.float32)).to(device)
        if os.path.isdir(orbax_dir):
            tree = load_checkpoint(orbax_dir)["params"]
        else:
            tree = _unflatten({k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")})
            for side, conv in (("down", "down"), ("up", "up")):
                for block in tree[side]:
                    block.setdefault("attns", [])
                    block.setdefault(conv, None)
    return params_from_jax(tree, device), cfg, embeddings



# ---------------------------------------------------------------------------
# DDPM training
# ---------------------------------------------------------------------------


def make_ddpm_loss(cfg: ToyGuidanceConfig, embeddings: torch.Tensor,
                   schedule: DiffusionSchedule = DiffusionSchedule(), uncond_dropout: float = 0.1):
    """loss(params, imgs [B, H, W, 3] in [0, 1], style_ids [B], generator,
    t=None, noise=None, drop=None): the eps-prediction objective
    mean((eps(x_t, t, c) - noise)^2), x_t = sqrt(a_t) x0 + sqrt(1 - a_t)
    noise, x0 the images scaled to [-1, 1]. t [B] in [0, T), the noise and
    the uncond dropout (drop [B] bool: the row conditions on the null
    embedding) are drawn from ``generator`` in that order unless given."""
    alphas = torch.as_tensor(schedule.alphas_cumprod, device=embeddings.device)
    n_styles = len(cfg.styles)

    def loss_fn(params, imgs, style_ids, generator=None, t=None, noise=None, drop=None):
        B, dev = imgs.shape[0], imgs.device
        x0 = imgs.permute(0, 3, 1, 2) * 2.0 - 1.0  # NCHW in [-1, 1]
        if t is None:
            t = torch.randint(0, schedule.num_train_timesteps, (B,), generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, dtype=x0.dtype, device=dev)
        if drop is None:
            drop = torch.rand((B,), generator=generator, device=dev) < uncond_dropout
        a_t = alphas[t][:, None, None, None]
        xt = torch.sqrt(a_t) * x0 + torch.sqrt(1.0 - a_t) * noise
        ids = torch.where(drop, n_styles, style_ids)
        eps = unet_apply(params, cfg.unet, xt, t, embeddings[ids])
        return torch.mean((eps - noise) ** 2)

    return loss_fn


def make_toy_train_step(cfg: ToyGuidanceConfig, embeddings: torch.Tensor, optimizer: torch.optim.Optimizer,
                        schedule: DiffusionSchedule = DiffusionSchedule(), uncond_dropout: float = 0.1):
    """step(params, imgs [B, H, W, 3], style_ids [B], generator=None, **draws)
    -> the loss (detached): one step of ``optimizer`` (over ``params``'
    leaves, which require grad; ``torch.optim.Adam(leaves(params), lr)``
    is ``optax.adam(lr)``) on the eps-prediction objective. With
    probability ``uncond_dropout`` a row conditions on the null embedding,
    so that classifier-free guidance has a trained uncond branch. ``draws``
    (t, noise, drop) override the generator's. The backward runs in full
    f32, as the forward."""
    loss_fn = make_ddpm_loss(cfg, embeddings, schedule, uncond_dropout)

    def step(params, imgs, style_ids, generator=None, **draws):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, imgs, style_ids, generator, **draws)
        with full_f32(imgs.device):
            loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_toy_train_scan(cfg: ToyGuidanceConfig, embeddings: torch.Tensor, optimizer: torch.optim.Optimizer,
                        schedule: DiffusionSchedule = DiffusionSchedule(), uncond_dropout: float = 0.1):
    """scan_steps(params, imgs_batches [S, B, H, W, 3], ids_batches [S, B],
    generator) -> the S losses [S]: ``make_toy_train_step`` over the S
    batches in order, with one optimizer (the JAX package scans them
    inside one executable; here they are S calls)."""
    step = make_toy_train_step(cfg, embeddings, optimizer, schedule, uncond_dropout)

    def scan_steps(params, imgs_batches, ids_batches, generator=None):
        return torch.stack([step(params, imgs, ids, generator) for imgs, ids in zip(imgs_batches, ids_batches)])

    return scan_steps


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------


def save_toy_guidance(path: str, params: dict, cfg: ToyGuidanceConfig, embeddings: torch.Tensor) -> None:
    """The JAX package's toy-guidance directory (models/toy_guidance.py:
    256-267): the orbax checkpoint ``params/`` of {"params": tree} in its
    layout (HWIO convolutions; a block's empty ``attns`` and None conv
    kept) and config.json; beside them params_torch.npz of the style
    embeddings, which the JAX package draws and the port reads back."""
    os.makedirs(path, exist_ok=True)

    def jax_layout(t):
        a = t.detach().cpu().numpy()
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a

    save_checkpoint(os.path.join(path, "params"), {"params": map_leaves(params, jax_layout)})
    np.savez(os.path.join(path, WEIGHTS_FILE), style_embeddings=embeddings.detach().cpu().numpy())
    with open(os.path.join(path, "config.json"), "w") as fp:
        json.dump({k: getattr(cfg, k) for k in CONFIG_KEYS}, fp, indent=1)
