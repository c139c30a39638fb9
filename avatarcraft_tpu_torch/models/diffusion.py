"""Score Distillation Sampling guidance (the reference's L5 layer): port of
the JAX package's models/diffusion.py (``DiffusionSchedule``,
``GuidanceModules``, ``SDSGuidance``, ``make_dummy_modules``; reference:
models/diffusion.py:24-333).

``sds_image_grad`` reproduces the reference's ``mannual_backward``: resize
the render to the guidance's image size (bilinear, antialiased when it
shrinks, as ``jax.image.resize`` is), encode WITH autograd, one random t in
[0.02T, 0.98T], the eps-prediction without autograd (SD 2.0-depth: the
render's depth resized to the latent grid, bicubic, min-max normalised to
[-1, 1] and concatenated to the UNet's input), classifier-free guidance,
the gradient w(t) (eps_hat - eps) clamped to +-1, pulled back through the
encoder and the resize by ``torch.autograd.grad`` (the JAX package's
``jax.vjp``). The encode and its pullback run in full f32.

txt2img (``produce_latents`` with the PNDM/PLMS or the DDIM update,
``prompt_to_img``) mirrors the reference's produce_latents /
decode_latents / prompt_to_img (models/diffusion.py:266-333).

t, the noise and the initial latents are drawn from a ``torch.Generator``
(the JAX package draws them from a ``jax.random`` key); ``t_override`` /
``noise_override`` and ``latents`` inject them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from avatarcraft_tpu_torch.models.sd import full_f32


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
    tokenizer: object | None = None
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


def resize_cubic(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, *size] as ``jax.image.resize(..., "cubic")``
    computes it: Keys' cubic with a = -0.5, widened by the scale when it
    shrinks, weights normalised over the taps inside the image. PyTorch's
    bicubic is that only with ``antialias=True`` (without, a = -0.75 and no
    widening)."""
    return F.interpolate(img, size=tuple(size), mode="bicubic", align_corners=False, antialias=True)


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
        scope: Callable[[str], contextlib.AbstractContextManager] | None = None,
    ) -> torch.Tensor:
        """d(SDS)/d(pred_rgb) [1, 3, H, W] for pred_rgb [1, 3, H, W] in [0, 1].

        t and the noise come from ``generator`` (on pred_rgb's device)
        unless injected by ``t_override`` (an int) and ``noise_override``
        (latent-shaped). ``pred_depth`` ([1, 1, H, W], any scale) conditions
        a depth-conditioned UNet (``modules.use_depth``, SD 2.0-depth;
        reference: models/diffusion.py:107-111,130-131). ``scope(part)``
        gives the context each part runs in (a caller's profiler ranges):
        'vae' the resize and the encode, then their pullback; 'sds' the
        noise, the UNet's pair and the guided gradient."""
        scope = scope or (lambda part: contextlib.nullcontext())
        dev = pred_rgb.device
        S = self.m.image_size
        img = pred_rgb.detach().requires_grad_()
        with scope("vae"), torch.enable_grad():
            latents = self.m.vae_encode(resize_bilinear(img, S))

        with scope("sds"), torch.no_grad():
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
            latents_noisy = torch.sqrt(a_t) * latents.detach() + torch.sqrt(1.0 - a_t) * noise
            lat2 = torch.cat([latents_noisy] * 2, dim=0)
            if self.m.use_depth and pred_depth is not None:
                d = resize_cubic(pred_depth.detach(), latents.shape[-2:])
                d = 2.0 * (d - d.min()) / (d.max() - d.min() + 1e-12) - 1.0
                lat2 = torch.cat([lat2, torch.cat([d] * 2, dim=0)], dim=1)
            t2 = torch.full((lat2.shape[0],), t, dtype=torch.int32, device=dev)
            eps_uncond, eps_text = self.m.unet(lat2, t2, text_embeddings).chunk(2, dim=0)
            eps_hat = eps_uncond + guidance_scale * (eps_text - eps_uncond)
            grad_lat = torch.clamp((1.0 - a_t) * (eps_hat - noise), -1.0, 1.0)
        with scope("vae"), full_f32(dev):
            (grad_img,) = torch.autograd.grad(latents, img, grad_lat.to(latents.dtype))
        return grad_img

    def sds_image_grad_batch(
        self,
        text_embeddings: torch.Tensor,
        pred_rgb: torch.Tensor,
        guidance_scale: float = 100.0,
        pred_depth: torch.Tensor | None = None,
        *,
        generator: torch.Generator | None = None,
        t_override=None,
        noise_override=None,
        scope: Callable[[str], contextlib.AbstractContextManager] | None = None,
    ) -> torch.Tensor:
        """``sds_image_grad`` of P images at once: d(SDS_p)/d(pred_rgb[p])
        [P, 3, H, W] for pred_rgb [P, 3, H, W] and the P prompts' CFG pairs
        ``text_embeddings`` [P, 2, L, D] (the JAX package's ``jax.vmap`` of
        sds_image_grad over the prompts, workloads/multi_stylize.py:243-246).

        One encode of the P resized images, one UNet call on 2P latents
        ordered [uncond_1..uncond_P, cond_1..cond_P] with the timesteps
        [t_1..t_P, t_1..t_P], one pullback. Each prompt has its own t and
        noise: drawn from ``generator`` prompt by prompt, t_p then noise_p,
        as P calls of sds_image_grad draw them in turn; ``t_override``
        (P ints) and ``noise_override`` (P latent-shaped [1, C, h, w] or one
        [P, C, h, w]) inject them. ``pred_depth`` [P, 1, H, W] conditions a
        depth-conditioned UNet, each prompt's depth min-max normalised on
        its own. ``scope`` as in sds_image_grad."""
        scope = scope or (lambda part: contextlib.nullcontext())
        dev = pred_rgb.device
        P = pred_rgb.shape[0]
        if text_embeddings.shape[:2] != (P, 2):
            raise ValueError(f"{P} images need [P, 2, L, D] embeddings, got {tuple(text_embeddings.shape)}")
        S = self.m.image_size
        img = pred_rgb.detach().requires_grad_()
        with scope("vae"), torch.enable_grad():
            latents = self.m.vae_encode(resize_bilinear(img, S))

        with scope("sds"), torch.no_grad():
            ts, noises = [], []
            for p in range(P):
                if t_override is not None:
                    ts.append(int(t_override[p]))
                else:
                    ts.append(int(torch.randint(self.schedule.min_step, self.schedule.max_step + 1, (1,),
                                                generator=generator, device=dev)))
                if noise_override is not None:
                    noises.append(torch.as_tensor(noise_override[p], dtype=latents.dtype, device=dev)
                                  .reshape(latents.shape[1:]))
                else:
                    noises.append(torch.randn(latents.shape[1:], generator=generator, dtype=latents.dtype,
                                              device=dev))
            noise = torch.stack(noises)
            t = torch.tensor(ts, dtype=torch.long, device=dev)
            a_t = self.alphas(dev)[t].reshape(P, 1, 1, 1)
            latents_noisy = torch.sqrt(a_t) * latents.detach() + torch.sqrt(1.0 - a_t) * noise
            lat2 = torch.cat([latents_noisy] * 2, dim=0)
            if self.m.use_depth and pred_depth is not None:
                d = resize_cubic(pred_depth.detach(), latents.shape[-2:])
                lo = d.amin(dim=(1, 2, 3), keepdim=True)
                hi = d.amax(dim=(1, 2, 3), keepdim=True)
                d = 2.0 * (d - lo) / (hi - lo + 1e-12) - 1.0
                lat2 = torch.cat([lat2, torch.cat([d] * 2, dim=0)], dim=1)
            t2 = torch.cat([t, t]).to(torch.int32)
            emb2 = torch.cat([text_embeddings[:, 0], text_embeddings[:, 1]], dim=0)
            eps_uncond, eps_text = self.m.unet(lat2, t2, emb2).chunk(2, dim=0)
            eps_hat = eps_uncond + guidance_scale * (eps_text - eps_uncond)
            grad_lat = torch.clamp((1.0 - a_t) * (eps_hat - noise), -1.0, 1.0)
        with scope("vae"), full_f32(dev):
            (grad_img,) = torch.autograd.grad(latents, img, grad_lat.to(latents.dtype))
        return grad_img

    # -- txt2img sampling ---------------------------------------------------
    def _cfg_eps(self, latents, t: int, text_embeddings, guidance_scale: float) -> torch.Tensor:
        """eps_uncond + scale (eps_text - eps_uncond) of one UNet call on
        the latents doubled."""
        lat2 = torch.cat([latents] * 2, dim=0)
        t2 = torch.full((lat2.shape[0],), int(t), dtype=torch.int32, device=latents.device)
        eps_u, eps_c = self.m.unet(lat2, t2, text_embeddings).chunk(2, dim=0)
        return eps_u + guidance_scale * (eps_c - eps_u)

    @torch.no_grad()
    def produce_latents(
        self,
        text_embeddings: torch.Tensor,
        height: int = 512,
        width: int = 512,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        latents: torch.Tensor | None = None,
        latent_channels: int | None = None,
        scheduler: str = "pndm",
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Deterministic txt2img sampling (reference: models/diffusion.py:266-290).

        ``scheduler='pndm'`` (the reference's) runs the PNDM/PLMS
        linear-multistep update in the Stable Diffusion pipeline's
        configuration (skip_prk_steps=True, steps_offset=1,
        set_alpha_to_one=False; diffusers scheduling_pndm.py: set_timesteps
        builds the PLMS timestep list, step_plms keeps a 4-deep eps
        history, _get_prev_sample applies the PNDM transfer coefficients).
        ``scheduler='ddim'`` takes the eta=0 DDIM update over the same
        alphas. The coefficients are the JAX package's, computed in numpy
        f32. Initial latents: ``latents``, else drawn from ``generator`` on
        the embeddings' device."""
        f = self.m.latent_scale
        B = text_embeddings.shape[0] // 2
        if latent_channels is None:
            latent_channels = self.m.latent_channels
        if latents is None:
            latents = torch.randn((B, latent_channels, height // f, width // f), generator=generator,
                                  device=text_embeddings.device)
        alphas = self.schedule.alphas_cumprod
        T = self.schedule.num_train_timesteps

        if scheduler == "ddim":
            step_ids = np.linspace(T - 1, 0, num_inference_steps).round().astype(np.int32)
            for i, t in enumerate(step_ids):
                eps_hat = self._cfg_eps(latents, t, text_embeddings, guidance_scale)
                a_t = alphas[t]
                a_prev = alphas[step_ids[i + 1]] if i + 1 < len(step_ids) else np.float32(1.0)
                x0 = (latents - float(np.sqrt(1 - a_t)) * eps_hat) / float(np.sqrt(a_t))
                latents = float(np.sqrt(a_prev)) * x0 + float(np.sqrt(1 - a_prev)) * eps_hat
            return latents

        if scheduler != "pndm":
            raise ValueError(f"unknown scheduler {scheduler!r}")

        # ---- PNDM / PLMS (SD pipeline config: skip_prk_steps) --------------
        ratio = T // num_inference_steps
        base = (np.arange(0, num_inference_steps) * ratio).round().astype(np.int64) + 1
        # the PLMS warm start visits the second timestep twice (diffusers
        # set_timesteps: concat(ts[:-1], ts[-2:-1], ts[-1:])[::-1])
        plms_ts = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1]

        # set_alpha_to_one=False: the final step targets alphas_cumprod[0]
        final_alpha = alphas[0]

        def prev_sample(sample, t, t_prev, eps):
            a_t = alphas[t]
            a_prev = alphas[t_prev] if t_prev >= 0 else final_alpha
            b_t = 1.0 - a_t
            b_prev = 1.0 - a_prev
            sample_coeff = (a_prev / a_t) ** 0.5
            denom = a_t * b_prev**0.5 + (a_t * b_t * a_prev) ** 0.5
            return float(sample_coeff) * sample - float(a_prev - a_t) * eps / float(denom)

        ets: list = []
        cur_sample = None
        for counter, t in enumerate(plms_ts):
            t = int(t)
            t_prev = t - ratio
            eps_hat = self._cfg_eps(latents, t, text_embeddings, guidance_scale)

            if counter != 1:
                ets = ets[-3:] + [eps_hat]
            else:
                # the warm start's replay: from the first sample, stepping from t + ratio
                t_prev = t
                t = t + ratio

            if len(ets) == 1 and counter == 0:
                eps_lms = eps_hat
                cur_sample = latents
            elif len(ets) == 1 and counter == 1:
                eps_lms = (eps_hat + ets[-1]) / 2.0
                latents = cur_sample
                cur_sample = None
            elif len(ets) == 2:
                eps_lms = (3.0 * ets[-1] - ets[-2]) / 2.0
            elif len(ets) == 3:
                eps_lms = (23.0 * ets[-1] - 16.0 * ets[-2] + 5.0 * ets[-3]) / 12.0
            else:
                eps_lms = (55.0 * ets[-1] - 59.0 * ets[-2] + 37.0 * ets[-3] - 9.0 * ets[-4]) / 24.0

            latents = prev_sample(latents, t, t_prev, eps_lms)
        return latents

    @torch.no_grad()
    def prompt_to_img(
        self,
        prompts,
        height: int = 512,
        width: int = 512,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        latents: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        scheduler: str = "pndm",
    ) -> np.ndarray:
        """prompts -> uint8 images [B, H, W, 3] (reference:
        models/diffusion.py:314-333: embeddings, produce_latents, the VAE
        decode, uint8 HWC). Without ``latents`` or ``generator`` the
        initial latents come from a generator seeded 0."""
        if self.m.vae_decode is None:
            raise ValueError("prompt_to_img needs modules with a VAE decoder")
        if isinstance(prompts, str):
            prompts = [prompts]
        text_embeddings = self.get_text_embeds(prompts)
        if latents is None and generator is None:
            generator = torch.Generator(text_embeddings.device).manual_seed(0)
        latents = self.produce_latents(
            text_embeddings, height=height, width=width, num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, latents=latents, scheduler=scheduler, generator=generator,
        )
        imgs = self.m.vae_decode(latents).permute(0, 2, 3, 1).cpu().numpy()  # [B, H, W, 3] in [0, 1]
        return (imgs * 255).round().astype(np.uint8)


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
