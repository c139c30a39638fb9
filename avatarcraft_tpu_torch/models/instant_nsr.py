"""The NeuS field (weight-norm SDF + color MLPs), the occupancy-guided fast
render and the 64+64 importance-sampled render. Port of the JAX package's
models/instant_nsr.py (FieldConfig, RenderConfig, init_field_params,
forward_*, sdf_and_gradient, up_sample, cat_z_vals, render_rays, sdf_tetra,
field_sdf_grad, FastRenderConfig, _probe_occupied, count_fast_samples,
render_rays_fast).

Both renders differentiate under PyTorch autograd; the JAX package's
``stop_gradient``s become evaluations under ``torch.no_grad()`` or
``.detach()`` at the same places. The render stages run as plain PyTorch on
every device for now; they are the plain versions of the port's future
kernels K1 (probe + select), K2 (compaction), K3 (pyramid encoder), K4
(fused fd4 field) and K5 (NeuS compositing), ROADMAP queue 2.

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
    init_pyramid_params,
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
from avatarcraft_tpu_torch.ops.sampling import (
    linspace,
    near_far_from_bound,
    recip,
    sample_pdf,
    stratified_z_vals,
)

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


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Hyperparameters of the importance-sampled render (reference:
    models/instant_nsr.py:133,358)."""

    num_steps: int = 64
    upsample_steps: int = 64
    upsample_round: int = 16  # importance samples added per round
    bound: float = 1.6
    perturb: bool = False
    cos_anneal_ratio: float = 1.0
    normal_epsilon_ratio: float = 0.0
    curvature_loss: bool = False
    normal_mode: str = "fd7"

    @property
    def total_steps(self) -> int:
        return self.num_steps + self.upsample_steps


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


def init_field_params(generator: torch.Generator, cfg: FieldConfig) -> dict:
    """Geometric init with weight norm (reference:
    models/instant_nsr.py:522-589), drawn from ``generator`` on its device.

    SDF MLP: hidden layers N(0, 2/out) (the input block of the first layer
    zero but its xyz columns), the last layer sqrt(pi)/sqrt(in) + 1e-4
    N(0, 1); g = max(||v||_row, 1e-8), b = 0. Color MLP: U(-1/sqrt(in),
    1/sqrt(in)), g = ||v||_row. Tables U(-1e-4, 1e-4). The tree, shapes and
    dtypes are the JAX package's; the random values are torch's."""
    _require_pyramid(cfg)
    dev = generator.device

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev)

    sdf_layers = []
    for l in range(cfg.num_layers):
        in_dim = cfg.sdf_in_dim if l == 0 else cfg.hidden_dim
        last = l == cfg.num_layers - 1
        out_dim = 1 + cfg.geo_feat_dim if last else cfg.hidden_dim
        if last:
            v = float(np.sqrt(np.pi) / np.sqrt(in_dim)) + 1e-4 * normal((out_dim, in_dim))
        elif l == 0 and cfg.include_input:
            v_x = normal((out_dim, 3)) * float(np.sqrt(2.0) / np.sqrt(out_dim))
            v = torch.cat([v_x, torch.zeros((out_dim, in_dim - 3), device=dev)], dim=1)
        else:
            v = normal((out_dim, in_dim)) * float(np.sqrt(2.0) / np.sqrt(out_dim))
        g = torch.linalg.norm(v, dim=1).clamp_min(1e-8)
        sdf_layers.append({"v": v, "g": g, "b": torch.zeros(out_dim, device=dev)})

    color_layers = []
    for l in range(cfg.num_layers_color):
        in_dim = cfg.color_in_dim if l == 0 else cfg.hidden_dim_color
        out_dim = 3 if l == cfg.num_layers_color - 1 else cfg.hidden_dim_color
        bound = float(1.0 / np.sqrt(in_dim))
        v = torch.rand((out_dim, in_dim), generator=generator, device=dev) * (2 * bound) - bound
        color_layers.append({"v": v, "g": torch.linalg.norm(v, dim=1)})

    return {
        "sdf": sdf_layers,
        "color": color_layers,
        "variance": torch.tensor(cfg.variance_init, dtype=torch.float32, device=dev),
        **init_pyramid_params(generator, cfg.pyramid),
    }


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


_FD_OFFSETS = np.array(
    [[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0], [0, -1, 0], [0, 0, -1]], dtype=np.float32
)


def sdf_and_gradient(params: dict, x: torch.Tensor, cfg: FieldConfig, bound: float, epsilon: float, packed: dict | None = None):
    """The reference's 7-point stencil (fd7): (sdf [N,1], feat [N,F],
    grad [N,3]) from the center and 6 central-difference taps, all 7 in one
    [7N, 3] network call (reference: models/instant_nsr.py:687-704)."""
    N = x.shape[0]
    offs = torch.as_tensor(_FD_OFFSETS * np.float32(epsilon), device=x.device)
    stenciled = torch.clamp(x[None, :, :] + offs[:, None, :], -bound, bound)
    all_pts = torch.cat([x[None], stenciled], dim=0).reshape(7 * N, 3)
    out = forward_sdf(params, all_pts, cfg, bound, packed).reshape(7, N, -1)
    grad = (0.5 * (out[1:4, :, 0] - out[4:7, :, 0]) * recip(epsilon)).T
    return out[0, :, :1], out[0, :, 1:], grad


def field_sdf_grad(params: dict, x: torch.Tensor, cfg: FieldConfig, bound: float, epsilon: float, mode: str, packed: dict | None = None):
    """(sdf [N,1], geo_feat [N,F], grad [N,3]) under the chosen normal mode:
    "fd7" (the reference's central differences) or "fd4" (the tetrahedral
    stencil). The analytic mode is not ported yet."""
    if mode == "fd4":
        return sdf_tetra(params, x, cfg, bound, epsilon, packed)
    if mode == "fd7":
        return sdf_and_gradient(params, x, cfg, bound, epsilon, packed)
    if mode == "analytic":
        raise NotImplementedError(
            "normal_mode 'analytic' is not ported yet (ROADMAP item 8: analytic normals)"
        )
    raise ValueError(f"unknown normal_mode: {mode!r}")


def up_sample(rays_o, rays_d, z_vals, sdf, n_importance: int, inv_s: float) -> torch.Tensor:
    """NeuS SDF-guided importance sampling at a fixed inv_s (reference:
    models/instant_nsr.py:410-475): [B, n_importance] new z values, outside
    autograd."""
    B = z_vals.shape[0]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    radius = torch.linalg.norm(pts, dim=-1)
    inside_sphere = (radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)

    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
    # min(cos, prev_cos) for robustness (reference: models/instant_nsr.py:442-445)
    prev_cos = torch.cat([torch.zeros((B, 1), dtype=cos_val.dtype, device=cos_val.device), cos_val[:, :-1]], dim=-1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside_sphere.to(cos_val.dtype)

    dist = next_z - prev_z
    prev_cdf = torch.sigmoid((mid_sdf - cos_val * dist * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid_sdf + cos_val * dist * 0.5) * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    trans = torch.cumprod(
        torch.cat([torch.ones((B, 1), dtype=alpha.dtype, device=alpha.device), 1.0 - alpha + 1e-7], dim=-1),
        dim=-1,
    )[:, :-1]
    return sample_pdf(z_vals, alpha * trans, n_importance, det=True).detach()


def cat_z_vals(sdf_fn, rays_o, rays_d, z_vals, new_z_vals, sdf, bound: float, last: bool):
    """Merge the new z values in (sorted per ray) and, unless ``last``,
    evaluate the SDF at the new points outside autograd. ``sdf_fn``:
    [M,3] -> [M, 1+F]. Returns (z [B, T+n], sdf [B, T+n])."""
    B, n_new = new_z_vals.shape
    z_sorted, order = torch.sort(torch.cat([z_vals, new_z_vals], dim=-1), dim=-1, stable=True)
    if last:
        return z_sorted, sdf
    pts = rays_o[:, None, :] + rays_d[:, None, :] * new_z_vals[..., None]
    pts = torch.clamp(pts, -bound, bound)
    with torch.no_grad():
        new_sdf = sdf_fn(pts.reshape(-1, 3))[:, 0].reshape(B, n_new)
    return z_sorted, torch.gather(torch.cat([sdf, new_sdf], dim=-1), -1, order)


def render_rays(
    params: dict,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    fcfg: FieldConfig,
    rcfg: RenderConfig,
    bg_color=1.0,
    generator: torch.Generator | None = None,
    warp_fn=None,
) -> dict:
    """The importance-sampled NeuS render of rays [N,3] on their device:
    ``num_steps`` stratified samples (jittered from ``generator`` with
    ``rcfg.perturb``), SDF-guided up-sampling in rounds of
    ``upsample_round`` outside autograd, midpoint resampling, one field
    evaluation with fd7 or fd4 normals, NeuS alpha compositing and the
    eikonal term (reference: models/instant_nsr.py:133-299). Same outputs
    as the JAX package's render_rays for a field without a warp."""
    if warp_fn is not None:
        raise NotImplementedError(
            "warp_fn is not ported yet (ROADMAP item 10, body model and warp)"
        )
    if rcfg.curvature_loss:
        raise NotImplementedError(
            "curvature_loss is not ported yet (ROADMAP item 19, parity pipeline)"
        )
    N = rays_o.shape[0]
    bound = rcfg.bound
    num_steps = rcfg.num_steps
    packed = materialize_field_tables(params, fcfg)

    def sdf_fn(x):
        return forward_sdf(params, x, fcfg, bound, packed)

    near, far = near_far_from_bound(rays_o, rays_d, bound)
    z_vals = stratified_z_vals(near, far, num_steps, perturb=rcfg.perturb, generator=generator)
    sample_dist = (far - near) * recip(num_steps)

    if rcfg.upsample_steps > 0:
        pts = torch.clamp(rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None], -bound, bound)
        with torch.no_grad():
            sdf_cur = sdf_fn(pts.reshape(-1, 3))[:, 0].reshape(N, num_steps)
        z_cur = z_vals
        n_rounds = rcfg.upsample_steps // rcfg.upsample_round
        for i in range(n_rounds):
            new_z = up_sample(rays_o, rays_d, z_cur, sdf_cur, rcfg.upsample_round, 64 * 2**i)
            z_cur, sdf_cur = cat_z_vals(
                sdf_fn, rays_o, rays_d, z_cur, new_z, sdf_cur, bound, last=(i + 1 == n_rounds)
            )
        z_vals = z_cur
    T = rcfg.total_steps

    # midpoint resampling (reference: models/instant_nsr.py:190-208)
    deltas = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], sample_dist.expand(N, 1)], dim=-1)
    z_mid = torch.cat([z_vals[:, :-1] + 0.5 * deltas[:, :-1], z_vals[:, -1:]], dim=-1)
    new_pts = rays_o[:, None, :] + rays_d[:, None, :] * z_mid[..., None]
    dirs = rays_d[:, None, :].expand(new_pts.shape)
    new_pts = torch.clamp(new_pts, -bound, bound)

    eps = 0.005 * (1.0 - rcfg.normal_epsilon_ratio)
    flat_pts = new_pts.reshape(-1, 3)
    sdf, geo_feat, gradient = field_sdf_grad(params, flat_pts, fcfg, bound, eps, rcfg.normal_mode, packed)
    normal = gradient / (1e-5 + _safe_norm(gradient))
    flat_dirs = dirs.reshape(-1, 3)
    color = forward_color(params, flat_pts, flat_dirs, normal, geo_feat, fcfg)
    inv_s = forward_variance(params)

    true_cos = torch.sum(flat_dirs * normal, dim=-1, keepdim=True)
    iter_cos = -(
        _softplus100(-true_cos * 0.5 + 0.5) * (1.0 - rcfg.cos_anneal_ratio)
        + _softplus100(-true_cos) * rcfg.cos_anneal_ratio
    )
    flat_deltas = deltas.reshape(-1, 1)
    prev_cdf = torch.sigmoid((sdf - iter_cos * flat_deltas * 0.5) * inv_s)
    next_cdf = torch.sigmoid((sdf + iter_cos * flat_deltas * 0.5) * inv_s)
    alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0).reshape(N, T)

    trans = torch.cumprod(
        torch.cat([torch.ones((N, 1), dtype=alpha.dtype, device=alpha.device), 1.0 - alpha + 1e-7], dim=-1),
        dim=-1,
    )[:, :-1]
    weights = alpha * trans
    weights_sum = weights.sum(dim=-1, keepdim=True)
    color = color.reshape(N, T, 3)
    image = (color * weights[:, :, None]).sum(dim=1)
    normal_map = (normal.reshape(N, T, 3) * weights[:, :, None]).sum(dim=1)
    depth = torch.sum(weights * torch.clamp((z_vals - near) / (far - near), 0.0, 1.0), dim=-1)

    # eikonal over the relaxed inside-sphere region
    # (reference: models/instant_nsr.py:266-272)
    pts_norm = torch.linalg.norm(flat_pts, dim=-1).reshape(N, T)
    relax_inside = (pts_norm < 1.2).float().detach()
    grad_err = (_safe_norm(gradient.reshape(N, T, 3), keepdim=False) - 1.0) ** 2
    gradient_error = (relax_inside * grad_err).sum() / (relax_inside.sum() + 1e-5)

    image = image + (1.0 - weights_sum) * bg_color
    return {
        "rgb": image,
        "depth": depth,
        "weights": weights,
        "weight_sum": weights_sum,
        "normal": normal_map,
        "gradient_error": gradient_error,
        "pts_color": color,
        "pts_alpha": alpha,
        "z_vals": z_vals,
    }


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
    """jnp.linspace(0, 1, m) in f32, value for value."""
    return linspace(0.0, 1.0, m, device)


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
        relax = ((pts_norm < 1.2) & valid).float().detach()
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
