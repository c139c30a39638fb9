"""The in-environment trained SDS guidance (the "toy" conditional denoiser):
port of the JAX package's models/toy_guidance.py (``STYLES``,
``style_index``, ``ToyGuidanceConfig``, the style embeddings,
``make_toy_modules`` and the loader).

A pixel-space conditional UNet (``models/sd.py`` at a miniature config)
DDPM-trained on procedural style targets; conditioning is one fixed
embedding per style keyword, the last row the null embedding of the empty
prompt (the classifier-free pair). View-augmented prompts ("front view of
the body of the lava") resolve to the style keyword they contain.

Weights: ``artifacts/toy_guidance/params_torch.npz`` beside the JAX
package's orbax checkpoint. It holds that checkpoint's leaves under
``params/<path>`` (the JAX tree's keys joined by "/", in its flattening
order) and the ``style_embeddings`` array, which the JAX package draws from
``jax.random.PRNGKey(seed)`` and which the port cannot draw itself. Run
``python tests/test_torch_toy_guidance.py`` to regenerate it (it needs the
JAX package and orbax). The DDPM trainer and the palette targets
(``style_map``, ``apply_style``) are still to port (ROADMAP item 15).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from avatarcraft_tpu_torch.models.diffusion import GuidanceModules
from avatarcraft_tpu_torch.models.sd import UNetConfig, unet_apply, unet_params_from_jax

# the style keywords of the committed checkpoint, in its order
STYLES: tuple = ("lava", "emerald", "porcelain")
WEIGHTS_FILE = "params_torch.npz"


def style_index(prompt: str) -> int:
    """Style id carried by a (possibly view-augmented) prompt; -1 = uncond.
    Matches by keyword containment (reference: render_utils.py:80-90 adds
    the view prefixes)."""
    for i, name in enumerate(STYLES):
        if name in prompt:
            return i
    return -1


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
    checkpoint directory: config.json and params_torch.npz, the tensors on
    ``device``. Blocks without attention or without a resampling conv get
    the JAX tree's empty list and None back (they hold no leaves)."""
    cfg = read_config(path)
    with np.load(os.path.join(path, WEIGHTS_FILE)) as z:
        flat = {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")}
        embeddings = torch.from_numpy(np.array(z["style_embeddings"], np.float32)).to(device)
    tree = _unflatten(flat)
    for side, conv in (("down", "down"), ("up", "up")):
        for block in tree[side]:
            block.setdefault("attns", [])
            block.setdefault(conv, None)
    return unet_params_from_jax(tree, device), cfg, embeddings
