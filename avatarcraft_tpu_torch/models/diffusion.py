"""Score Distillation Sampling guidance (the reference's L5 layer): port of
the JAX package's models/diffusion.py (``DiffusionSchedule``,
``GuidanceModules``, ``SDSGuidance.get_text_embeds`` and
``SDSGuidance.sds_image_grad``, ``make_dummy_modules``; reference:
models/diffusion.py:24-149).

``sds_image_grad`` reproduces the reference's ``mannual_backward``: resize
the render to the guidance's image size (bilinear, antialiased when it
shrinks, as ``jax.image.resize`` is), encode WITH autograd, one random t in
[0.02T, 0.98T], the eps-prediction without autograd, classifier-free
guidance, the gradient w(t) (eps_hat - eps) clamped to +-1, pulled back
through the encoder and the resize by ``torch.autograd.grad`` (the JAX
package's ``jax.vjp``).

t and the noise are drawn from a ``torch.Generator`` (the JAX package draws
them from a ``jax.random`` key); ``t_override`` / ``noise_override`` inject
them. txt2img sampling (``produce_latents``, ``prompt_to_img``) is still to
port (ROADMAP item 15).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Scaled-linear beta schedule (SD default; reference: models/diffusion.py:63)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012

    @property
    def betas(self) -> np.ndarray:
        return (
            np.linspace(
                self.beta_start**0.5,
                self.beta_end**0.5,
                self.num_train_timesteps,
                dtype=np.float64,
            )
            ** 2
        )

    @property
    def alphas_cumprod(self) -> np.ndarray:
        return np.cumprod(1.0 - self.betas).astype(np.float32)

    @property
    def min_step(self) -> int:
        return int(self.num_train_timesteps * 0.02)

    @property
    def max_step(self) -> int:
        return int(self.num_train_timesteps * 0.98)


@dataclasses.dataclass(frozen=True)
class GuidanceModules:
    """The three injected networks.

    unet:        (latents [B,C,h,w], t [B], text_emb [B,L,D]) -> eps [B,C,h,w]
    vae_encode:  (images [B,3,H,W] in [0,1]) -> latents [B,C,h,w]
    text_encode: (list[str]) -> [n, L, D] embeddings
    """

    unet: Callable
    vae_encode: Callable
    text_encode: Callable
    latent_scale: int = 8  # image->latent downsampling factor
    latent_channels: int = 4
    image_size: int = 512
    vae_decode: Callable | None = None  # latents -> images (txt2img)
    configs: dict | None = None
    use_depth: bool = False  # SD 2.0-depth: concat depth to the latent input


def resize_bilinear(img: torch.Tensor, size: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, size, size] as ``jax.image.resize(...,
    "bilinear")`` computes it: a triangle filter widened by the scale when
    it shrinks (antialiasing), weights normalised over the taps inside the
    image; the identity when the size is already right."""
    if tuple(img.shape[-2:]) == (size, size):
        return img
    return F.interpolate(img, size=(size, size), mode="bilinear", align_corners=False, antialias=True)


class SDSGuidance:
    """Functional SDS guidance with reference-parity semantics, on the
    device of the tensors it is given."""

    def __init__(self, modules: GuidanceModules, schedule: DiffusionSchedule = DiffusionSchedule()):
        self.m = modules
        self.schedule = schedule
        self._alphas = torch.as_tensor(schedule.alphas_cumprod)

    def alphas(self, device) -> torch.Tensor:
        """alphas_cumprod [T] f32 on ``device``."""
        if self._alphas.device != torch.device(device):
            self._alphas = self._alphas.to(device)
        return self._alphas

    # -- text ---------------------------------------------------------------
    def get_text_embeds(self, prompts) -> torch.Tensor:
        """[uncond; cond] CFG pair (reference: models/diffusion.py:72-89)."""
        if not isinstance(prompts, (list, tuple)):
            prompts = [prompts]
        cond = self.m.text_encode(list(prompts))
        uncond = self.m.text_encode([""] * len(prompts))
        return torch.cat([uncond, cond], dim=0)

    # -- SDS ----------------------------------------------------------------
    def sds_image_grad(
        self,
        text_embeddings: torch.Tensor,
        pred_rgb: torch.Tensor,
        guidance_scale: float = 100.0,
        pred_depth: torch.Tensor | None = None,
        *,
        generator: torch.Generator | None = None,
        t_override=None,
        noise_override=None,
    ) -> torch.Tensor:
        """d(SDS)/d(pred_rgb) [1, 3, H, W] for pred_rgb [1, 3, H, W] in [0, 1].

        t and the noise come from ``generator`` (on pred_rgb's device)
        unless injected by ``t_override`` (an int) and ``noise_override``
        (latent-shaped). A depth-conditioned UNet (SD 2.0-depth) comes with
        the Stable Diffusion modules (ROADMAP item 17)."""
        if self.m.use_depth and pred_depth is not None:
            raise NotImplementedError(
                "depth-conditioned guidance comes with the Stable Diffusion modules (ROADMAP item 17)"
            )
        dev = pred_rgb.device
        S = self.m.image_size
        img = pred_rgb.detach().requires_grad_()
        with torch.enable_grad():
            latents = self.m.vae_encode(resize_bilinear(img, S))

        if t_override is not None:
            t = int(t_override)
        else:
            t = int(torch.randint(self.schedule.min_step, self.schedule.max_step + 1, (1,),
                                  generator=generator, device=dev))
        if noise_override is not None:
            noise = torch.as_tensor(noise_override, dtype=latents.dtype, device=dev)
        else:
            noise = torch.randn(latents.shape, generator=generator, dtype=latents.dtype, device=dev)
        a_t = self.alphas(dev)[t]
        with torch.no_grad():
            latents_noisy = torch.sqrt(a_t) * latents.detach() + torch.sqrt(1.0 - a_t) * noise
            lat2 = torch.cat([latents_noisy] * 2, dim=0)
            t2 = torch.full((lat2.shape[0],), t, dtype=torch.int32, device=dev)
            eps_uncond, eps_text = self.m.unet(lat2, t2, text_embeddings).chunk(2, dim=0)
            eps_hat = eps_uncond + guidance_scale * (eps_text - eps_uncond)
            grad_lat = torch.clamp((1.0 - a_t) * (eps_hat - noise), -1.0, 1.0)
        (grad_img,) = torch.autograd.grad(latents, img, grad_lat.to(latents.dtype))
        return grad_img


def make_dummy_modules(latent_channels: int = 4, image_size: int = 64, emb_dim: int = 32,
                       seq_len: int = 8, device="cuda") -> GuidanceModules:
    """Deterministic stand-in networks for tests and pipeline smoke runs.

    The text encoder seeds a torch generator from Python's ``hash(prompt)``,
    which changes from process to process (string hashing is salted), as
    the JAX package's does from a jax.random key; its embeddings are not
    the JAX package's."""

    def unet(latents, t, text_emb):
        # time + text conditioned pseudo-eps: deterministic, smooth, nonzero
        t_feat = torch.cos(t.to(torch.float32) / 100.0)[:, None, None, None]
        txt = torch.mean(text_emb, dim=(1, 2))[:, None, None, None]
        return torch.tanh(latents) * t_feat + 0.1 * txt

    def vae_encode(images):
        # strided average-pool "encoder": differentiable, shape-correct
        B, C, H, W = images.shape
        f = 8
        lat = images.reshape(B, C, H // f, f, W // f, f).mean(dim=(3, 5))
        lat = torch.cat([lat, lat[:, :1]], dim=1)  # 3 -> 4 channels
        return lat * 0.18215

    def text_encode(prompts):
        out = []
        for p in prompts:
            gen = torch.Generator().manual_seed(abs(hash(p)) % (2**31))
            out.append(torch.randn((seq_len, emb_dim), generator=gen))
        return torch.stack(out).to(device)

    return GuidanceModules(unet=unet, vae_encode=vae_encode, text_encode=text_encode, image_size=image_size,
                           latent_channels=latent_channels)
