"""The NeuS field (weight-norm SDF + color MLPs) and the occupancy-guided
fast render, forward only. Port of the JAX package's models/instant_nsr.py
(FieldConfig, forward_*, sdf_tetra, field_sdf_grad, FastRenderConfig,
_probe_occupied, count_fast_samples, render_rays_fast).

The render stages run as plain PyTorch on every device for now; they are the
plain versions of the port's future kernels K1 (probe + select), K2
(compaction), K3 (pyramid encoder), K4 (fused fd4 field) and K5 (NeuS
compositing), ROADMAP queue 2.

Weight norm (w = g * v / ||v||_row) matches torch.nn.utils.weight_norm, so
reference checkpoints load unchanged (reference:
models/instant_nsr.py:555-556,585-586).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from avatarcraft_tpu_torch.ops.grid_encoder import (
    PyramidSpec,
    materialize_packed,
    pyramid_encode,
)
from avatarcraft_tpu_torch.ops.occupancy import (
    compact_indices,
    occupancy_lookup_bits,
    pack_occupancy_bits,
    scatter_to_flat,
    select_occupied_samples,
)
from avatarcraft_tpu_torch.ops.sampling import near_far_from_bound, recip

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Configuration of the instant-NGP hash grid, kept so that checkpoint
    sidecars naming it parse. The hash encoder itself is ported with the
    parity pipeline (ROADMAP item 19, kernel K8)."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: int | None = 2048
    per_level_scale: float = 2.0

    def __post_init__(self):
        if self.desired_resolution is not None:
            # desired_resolution overrides per_level_scale
            # (reference: encoder/hashencoder/hashgrid.py:84-85)
            scale = float(
                np.exp2(
                    np.log2(self.desired_resolution / self.base_resolution)
                    / (self.num_levels - 1)
                )
            )
            object.__setattr__(self, "per_level_scale", scale)

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Network hyperparameters (reference: models/instant_nsr.py:479-494).
    Same fields as the JAX package's FieldConfig, so its sidecar JSON loads
    as it is."""

    grid: HashGridSpec = HashGridSpec()
    pyramid: PyramidSpec = PyramidSpec()
    encoder: str = "hashgrid"
    packed_dtype: str = "bfloat16"
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    include_input: bool = True
    use_viewdirs: bool = False
    sh_degree: int = 4
    variance_init: float = 0.3
    # matmul input dtype of the color MLP (f32 accumulation either way);
    # the SDF MLP is always f32: its outputs feed finite-difference normals
    mlp_dtype: str = "float32"

    @property
    def encoder_dim(self) -> int:
        if self.encoder == "hashgrid":
            return self.grid.output_dim
        return self.pyramid.output_dim

    @property
    def sdf_in_dim(self) -> int:
        return self.encoder_dim + (3 if self.include_input else 0)

    @property
    def color_in_dim(self) -> int:
        d = self.geo_feat_dim + 6
        if self.use_viewdirs:
            d += self.sh_degree**2
        return d


def _require_pyramid(cfg: FieldConfig) -> None:
    if cfg.encoder != "tpu_pyramid":
        raise NotImplementedError(
            f"encoder {cfg.encoder!r} is not ported yet: the hash encoder comes "
            "with the parity pipeline (ROADMAP item 19, kernel K8)"
        )
    if cfg.use_viewdirs:
        raise NotImplementedError(
            "use_viewdirs needs the SH encoder, ported with the legacy models "
            "(ROADMAP item 20)"
        )


def _weight_norm_apply(layer: dict) -> torch.Tensor:
    """w = g * v / ||v||_row, rows = output channels (weight_norm dim=0)."""
    v = layer["v"]
    norm = torch.linalg.norm(v, dim=1, keepdim=True)
    return v * (layer["g"][:, None] / (norm + 1e-12))


def _softplus100(x: torch.Tensor) -> torch.Tensor:
    """Softplus with beta=100 (reference: models/instant_nsr.py:591)."""
    return F.softplus(x * 100.0) * recip(100.0)


def _safe_norm(x: torch.Tensor, dim=-1, keepdim=True) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + 1e-12)


def materialize_field_tables(params: dict, cfg: FieldConfig) -> dict:
    """The cell-packed pyramid tables in ``cfg.packed_dtype`` (bf16 for the
    artifact). Build once per frame and pass to every render call."""
    _require_pyramid(cfg)
    return materialize_packed(params, cfg.pyramid, _DTYPES[cfg.packed_dtype])


def encode_position(params: dict, x: torch.Tensor, cfg: FieldConfig, bound: float, packed: dict | None = None) -> torch.Tensor:
    if packed is None:
        packed = materialize_field_tables(params, cfg)
    return pyramid_encode(packed, x, cfg.pyramid, size=bound)


def forward_sdf(params: dict, x: torch.Tensor, cfg: FieldConfig, bound: float, packed: dict | None = None) -> torch.Tensor:
    """[N,3] -> [N, 1+geo_feat_dim]; h = [x, enc(x)] through the f32 SDF MLP
    (reference: models/instant_nsr.py:627-642)."""
    h = encode_position(params, x, cfg, bound, packed).float()
    if cfg.include_input:
        h = torch.cat([x, h], dim=-1)
    n = len(params["sdf"])
    for l, layer in enumerate(params["sdf"]):
        h = h @ _weight_norm_apply(layer).T + layer["b"]
        if l != n - 1:
            h = _softplus100(h)
    return h


def forward_color(params: dict, x, d, normal, geo_feat, cfg: FieldConfig) -> torch.Tensor:
    """[x, n, geo_feat] -> rgb in [0,1], bias-free relu MLP
    (reference: models/instant_nsr.py:644-663)."""
    _require_pyramid(cfg)
    h = torch.cat([x, normal, geo_feat], dim=-1)
    n = len(params["color"])
    mdt = _DTYPES[cfg.mlp_dtype]
    for l, layer in enumerate(params["color"]):
        w = _weight_norm_apply(layer)
        # inputs rounded to mlp_dtype, products and sums in f32
        h = h.to(mdt).float() @ w.T.to(mdt).float()
        if l != n - 1:
            h = torch.relu(h)
    return torch.sigmoid(h)


def forward_variance(params: dict) -> torch.Tensor:
    """inv_s = exp(10 * v), clipped (reference: models/instant_nsr.py:665-667)."""
    return torch.clamp(torch.exp(params["variance"] * 10.0), 1e-6, 1e6)


_TETRA_DIRS = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], dtype=np.float32)


def sdf_tetra(params: dict, x: torch.Tensor, cfg: FieldConfig, bound: float, epsilon: float, packed: dict | None = None):
    """4-tap tetrahedral stencil: (sdf [N,1], feat [N,F], grad [N,3]).

    grad = sum_i v_i f(x + eps v_i) / (4 eps); sdf and features are the
    stencil mean. All 4 taps go through one [4N, 3] network call.
    """
    N = x.shape[0]
    dirs = torch.as_tensor(_TETRA_DIRS, device=x.device)
    pts = torch.clamp(x[None, :, :] + epsilon * dirs[:, None, :], -bound, bound)
    out = forward_sdf(params, pts.reshape(4 * N, 3), cfg, bound, packed).reshape(4, N, -1)
    sdf = out[..., :1].mean(dim=0)
    feat = out[..., 1:].mean(dim=0)
    grad = torch.einsum("sc,sn->nc", dirs, out[..., 0]) * recip(4.0 * epsilon)
    return sdf, feat, grad


def field_sdf_grad(params: dict, x: torch.Tensor, cfg: FieldConfig, bound: float, epsilon: float, mode: str, packed: dict | None = None):
    """(sdf [N,1], geo_feat [N,F], grad [N,3]) under the chosen normal mode.
    Only "fd4" (the artifact's mode) is ported."""
    if mode == "fd4":
        return sdf_tetra(params, x, cfg, bound, epsilon, packed)
    if mode in ("analytic", "fd7"):
        raise NotImplementedError(
            f"normal_mode {mode!r} is not ported yet (ROADMAP item 8: "
            "analytic and fd7 normals)"
        )
    raise ValueError(f"unknown normal_mode: {mode!r}")


@dataclasses.dataclass(frozen=True)
class FastRenderConfig:
    """Occupancy-guided render: M uniform probes -> K field samples."""

    n_probes: int = 192
    k_samples: int = 32
    bound: float = 1.6
    fd_epsilon: float = 0.005
    # evaluate the field on at most this many samples per call (global
    # compaction, reference: raymarching.cu:156-221); 0 = all N*K slots
    sample_budget: int = 0
    # density cutoff min(occ_threshold, mean(grid)) (raymarching.cu:21,75)
    occ_threshold: float = 10.0
    cos_anneal_ratio: float = 1.0
    normal_mode: str = "fd4"


def _linspace01(m: int, device) -> torch.Tensor:
    """jnp.linspace(0, 1, m) in f32, value for value: iota * f32(1/(m-1)), last 1."""
    t = torch.arange(m - 1, dtype=torch.float32, device=device) * recip(m - 1)
    return torch.cat([t, torch.ones(1, dtype=torch.float32, device=device)])


def _probe_occupied(rays_o, rays_d, near, far, cfg: FastRenderConfig, density_grid: torch.Tensor):
    """M uniform probe depths per ray + their fine-grid occupancy (bool),
    looked up through the bit-packed table."""
    t = _linspace01(cfg.n_probes, rays_o.device)
    z_probe = near + (far - near) * t[None, :]
    p_probe = rays_o[:, None, :] + rays_d[:, None, :] * z_probe[..., None]
    thresh = torch.clamp(density_grid.mean(), max=cfg.occ_threshold)
    packed = pack_occupancy_bits(density_grid, thresh)
    occupied = occupancy_lookup_bits(packed, density_grid.shape[0], p_probe, cfg.bound)
    return z_probe, occupied


def count_fast_samples(rays_o, rays_d, cfg: FastRenderConfig, density_grid: torch.Tensor) -> torch.Tensor:
    """Number of grid-occupied samples the fast path would evaluate for this
    ray batch (probe + selection only, no field). Sizes the sample budget
    and checks that a render clipped nothing."""
    near, far = near_far_from_bound(rays_o, rays_d, cfg.bound)
    z_probe, occupied = _probe_occupied(rays_o, rays_d, near, far, cfg, density_grid)
    _, valid = select_occupied_samples(z_probe, occupied, cfg.k_samples, 0.5)
    return valid.sum()


def render_rays_fast(
    params: dict,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    fcfg: FieldConfig,
    cfg: FastRenderConfig,
    density_grid: torch.Tensor,
    bg_color=1.0,
    packed: dict | None = None,
) -> dict:
    """Occupancy-culled NeuS render of rays [N,3] on their device: the
    network runs only on the K grid-occupied samples per ray, and with
    ``cfg.sample_budget`` only on the first ``sample_budget`` of those in
    flat order. ``packed``: the frame's materialize_field_tables (built here
    when omitted). Same outputs as the JAX package's render_rays_fast."""
    N = rays_o.shape[0]
    K = cfg.k_samples
    bound = cfg.bound
    if packed is None:
        packed = materialize_field_tables(params, fcfg)

    # profiler ranges name the stage each future kernel takes over
    with record_function("render.probe_select"):  # K1
        near, far = near_far_from_bound(rays_o, rays_d, bound)
        z_probe, occupied = _probe_occupied(rays_o, rays_d, near, far, cfg, density_grid)
        z_sel, valid = select_occupied_samples(z_probe, occupied, K, 0.5)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_sel[..., None]
        pts = torch.clamp(pts, -bound, bound)
        flat = pts.reshape(-1, 3)
        dirs = rays_d[:, None, :].expand(pts.shape).reshape(-1, 3)
    T = flat.shape[0]

    def field(x, d):
        with record_function("render.field_fd4"):  # K3 + K4
            sdf_, feat_, grad_ = field_sdf_grad(
                params, x, fcfg, bound, cfg.fd_epsilon, cfg.normal_mode, packed
            )
            normal_ = grad_ / (1e-5 + _safe_norm(grad_))
        with record_function("render.color"):  # K4
            color_ = forward_color(params, x, d, normal_, feat_, fcfg)
        return sdf_, grad_, normal_, color_

    if cfg.sample_budget and cfg.sample_budget < T:
        with record_function("render.compact"):  # K2
            sel, kept = compact_indices(valid.reshape(-1), cfg.sample_budget)
            n_kept = kept.sum()
            flat_c, dirs_c = flat[sel], dirs[sel]
        sdf_c, grad_c, normal_c, color_c = field(flat_c, dirs_c)
        with record_function("render.scatter"):  # K2
            norm_c = torch.linalg.norm(flat_c, dim=-1, keepdim=True)
            sdf = scatter_to_flat(sdf_c, sel, T, n_kept)
            grad = scatter_to_flat(grad_c, sel, T, n_kept)
            normal = scatter_to_flat(normal_c, sel, T, n_kept)
            color = scatter_to_flat(color_c, sel, T, n_kept)
            pts_norm_flat = scatter_to_flat(norm_c, sel, T, n_kept)[:, 0]
            valid = kept.reshape(N, K)
    else:
        sdf, grad, normal, color = field(flat, dirs)
        pts_norm_flat = torch.linalg.norm(flat, dim=-1)
    with record_function("render.composite"):  # K5
        inv_s = forward_variance(params)

        # a transition into an invalid slot falls back to the probe spacing; the
        # invalid slots' own alphas are masked by `valid` below
        spacing = (far - near) * recip(cfg.n_probes)
        diffs = torch.where(valid[:, 1:], z_sel[:, 1:] - z_sel[:, :-1], spacing)
        deltas = torch.cat([diffs, spacing], dim=-1)
        true_cos = torch.sum(dirs * normal, dim=-1, keepdim=True)
        iter_cos = -(
            _softplus100(-true_cos * 0.5 + 0.5) * (1.0 - cfg.cos_anneal_ratio)
            + _softplus100(-true_cos) * cfg.cos_anneal_ratio
        )
        fd = deltas.reshape(-1, 1)
        prev_cdf = torch.sigmoid((sdf - iter_cos * fd * 0.5) * inv_s)
        next_cdf = torch.sigmoid((sdf + iter_cos * fd * 0.5) * inv_s)
        alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
        alpha = alpha.reshape(N, K) * valid.to(alpha.dtype)

        trans = torch.cumprod(
            torch.cat([torch.ones((N, 1), dtype=alpha.dtype, device=alpha.device), 1.0 - alpha + 1e-7], dim=-1),
            dim=-1,
        )[:, :-1]
        weights = alpha * trans
        weights_sum = weights.sum(dim=-1, keepdim=True)

        image = (color.reshape(N, K, 3) * weights[:, :, None]).sum(dim=1)
        normal_map = (normal.reshape(N, K, 3) * weights[:, :, None]).sum(dim=1)
        depth = torch.sum(weights * torch.clamp((z_sel - near) / (far - near), 0, 1), dim=-1)
        image = image + (1.0 - weights_sum) * bg_color

        # eikonal over valid samples in the relaxed inside-sphere region
        pts_norm = pts_norm_flat.reshape(N, K)
        relax = ((pts_norm < 1.2) & valid).float()
        gerr = (_safe_norm(grad.reshape(N, K, 3), keepdim=False) - 1.0) ** 2
        gradient_error = (relax * gerr).sum() / (relax.sum() + 1e-5)

        return {
            "rgb": image,
            "depth": depth,
            "weights": weights,
            "weight_sum": weights_sum,
            "normal": normal_map,
            "gradient_error": gradient_error,
        }
