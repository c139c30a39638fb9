"""The NeuS field (weight-norm SDF + color MLPs), the occupancy-guided fast
render and the 64+64 importance-sampled render. Port of the JAX package's
models/instant_nsr.py (FieldConfig, RenderConfig, init_field_params and
the encoder dispatch for the hash grid and the pyramid, forward_*, density,
sdf_and_gradient, up_sample, cat_z_vals, render_rays, render_rays_chunked,
sdf_tetra, the analytic normals, field_sdf_grad, FieldFns,
network_field_fns, FastRenderConfig, _probe_occupied, count_fast_samples,
render_rays and render_rays_fast with their ``field``, ``near_far``
and ``warp_fn``, the curvature term,
extract_sdf_grid, extract_geometry).

Both renders differentiate under PyTorch autograd; the JAX package's
``stop_gradient``s become evaluations under ``torch.no_grad()`` or
``.detach()`` at the same places. The render stages run as plain PyTorch on
every device for now; they are the plain versions of the port's future
kernels K1 (probe + select), K2 (compaction), K3 (pyramid encoder), K4
(fused fd4 field), K5 (NeuS compositing) and K8 (hash encoder), ROADMAP
queue 2.

Weight norm (w = g * v / ||v||_row) matches torch.nn.utils.weight_norm, so
reference checkpoints load unchanged (reference:
models/instant_nsr.py:555-556,585-586).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

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
from avatarcraft_tpu_torch.ops.hash_encoder import (
    HashGridSpec,
    hash_encode,
    init_hash_table,
    pack_dense_cells,
)
from avatarcraft_tpu_torch.ops.occupancy import (
    compact_indices,
    occupancy_lookup_bits,
    pack_occupancy_bits,
    scatter_to_flat,
    select_occupied_samples,
)
from avatarcraft_tpu_torch.ops.sampling import (
    device_constant,
    linspace,
    near_far_from_bound,
    recip,
    sample_pdf,
    stratified_z_vals,
)
from avatarcraft_tpu_torch.ops.sh_encoder import sh_encode

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


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
        # [x, (sh(d)), normal, geo_feat] (reference: models/instant_nsr.py:564-569)
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


def _check_encoder(cfg: FieldConfig) -> None:
    if cfg.encoder not in ("hashgrid", "tpu_pyramid"):
        raise ValueError(f"unknown encoder: {cfg.encoder!r}")


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
    1/sqrt(in)), g = ||v||_row. Tables U(-1e-4, 1e-4): the hash table
    ("table") or the pyramid's grids and planes, after ``cfg.encoder``. The
    tree, shapes and dtypes are the JAX package's; the random values are
    torch's."""
    _check_encoder(cfg)
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

    params = {
        "sdf": sdf_layers,
        "color": color_layers,
        "variance": torch.tensor(cfg.variance_init, dtype=torch.float32, device=dev),
    }
    if cfg.encoder == "hashgrid":
        params["table"] = init_hash_table(generator, cfg.grid)
    else:
        params.update(init_pyramid_params(generator, cfg.pyramid))
    return params


def _softplus100(x: torch.Tensor) -> torch.Tensor:
    """Softplus with beta=100 (reference: models/instant_nsr.py:591)."""
    return F.softplus(x * 100.0) * recip(100.0)


class _TransmittanceCumprod(torch.autograd.Function):
    """``torch.cumprod`` along the last dim of factors with no zero (the
    transmittance factors 1 - alpha + 1e-7 >= 1e-7), with torch's own
    backward for that case, reversed_cumsum(out * grad) / x, the same
    numbers: torch's backward first asks the card whether any factor is 0
    (a host read), which a CUDA graph cannot hold."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (out * grad).flip(-1).cumsum(-1).flip(-1).div(x)


def _transmittance(alpha: torch.Tensor) -> torch.Tensor:
    """[N, T] transmittance before each sample: the exclusive cumprod of
    1 - alpha + 1e-7 (the reference's +1e-7)."""
    ones = torch.ones((alpha.shape[0], 1), dtype=alpha.dtype, device=alpha.device)
    return _TransmittanceCumprod.apply(torch.cat([ones, 1.0 - alpha + 1e-7], dim=-1))[:, :-1]


def _safe_norm(x: torch.Tensor, dim=-1, keepdim=True) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + 1e-12)


def table_dtype(cfg: FieldConfig) -> torch.dtype:
    """The dtype of the field's lookup tables: ``cfg.packed_dtype`` for the
    pyramid, f32 for the hash grid (its table and dense cells)."""
    return torch.float32 if cfg.encoder == "hashgrid" else _DTYPES[cfg.packed_dtype]


def materialize_field_tables(params: dict, cfg: FieldConfig) -> dict:
    """The lookup tables of one frame or train step, built once and passed
    to every render call: the cell-packed pyramid tables in
    ``cfg.packed_dtype`` (bf16 for the artifact), or for the hash grid the
    cell-packed tables of its dense levels (``{"dense_cells": ...}``, in
    the table's f32; ``packed_dtype`` does not apply)."""
    _check_encoder(cfg)
    if cfg.encoder == "hashgrid":
        return {"dense_cells": pack_dense_cells(params["table"], cfg.grid)}
    return materialize_packed(params, cfg.pyramid, _DTYPES[cfg.packed_dtype])


def encode_position(params: dict, x: torch.Tensor, cfg: FieldConfig, bound: float, packed: dict | None = None) -> torch.Tensor:
    """The spatial encoding of ``x`` through ``cfg.encoder``. The hash grid
    reads its dense levels from ``packed`` where given, else from the
    table (the same numbers)."""
    if cfg.encoder == "hashgrid":
        cells = packed.get("dense_cells") if packed is not None else None
        return hash_encode(params["table"], x, cfg.grid, size=bound, packed_cells=cells)
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
    """[x, (sh(d)), n, geo_feat] -> rgb in [0,1], bias-free relu MLP; the
    SH encoding of the directions ``d`` when ``cfg.use_viewdirs``
    (reference: models/instant_nsr.py:644-663)."""
    if cfg.use_viewdirs:
        h = torch.cat([x, sh_encode(d, cfg.sh_degree), normal, geo_feat], dim=-1)
    else:
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


def density(params: dict, x: torch.Tensor, cfg: FieldConfig, bound: float) -> torch.Tensor:
    """The SDF value only, [N] (reference: models/instant_nsr.py:669-681)."""
    return forward_sdf(params, x, cfg, bound)[..., 0]


_TETRA_DIRS = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], dtype=np.float32)


def _sdf_fn(params: dict, cfg: FieldConfig, bound: float, packed: dict | None):
    return lambda x: forward_sdf(params, x, cfg, bound, packed)


def _tetra(sdf_fn, x: torch.Tensor, bound: float, epsilon: float):
    """The 4-tap tetrahedral stencil through ``sdf_fn`` ([M,3] -> [M,1+F])."""
    N = x.shape[0]
    dirs = device_constant(tuple(map(tuple, _TETRA_DIRS.tolist())), torch.float32, x.device)
    pts = torch.clamp(x[None, :, :] + epsilon * dirs[:, None, :], -bound, bound)
    out = sdf_fn(pts.reshape(4 * N, 3)).reshape(4, N, -1)
    sdf = out[..., :1].mean(dim=0)
    feat = out[..., 1:].mean(dim=0)
    grad = torch.einsum("sc,sn->nc", dirs, out[..., 0]) * recip(4.0 * epsilon)
    return sdf, feat, grad


def sdf_tetra(params: dict, x: torch.Tensor, cfg: FieldConfig, bound: float, epsilon: float, packed: dict | None = None):
    """4-tap tetrahedral stencil: (sdf [N,1], feat [N,F], grad [N,3]).

    grad = sum_i v_i f(x + eps v_i) / (4 eps); sdf and features are the
    stencil mean. All 4 taps go through one [4N, 3] network call.
    """
    return _tetra(_sdf_fn(params, cfg, bound, packed), x, bound, epsilon)


_FD_OFFSETS = np.array(
    [[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0], [0, -1, 0], [0, 0, -1]], dtype=np.float32
)


def _fd7(sdf_fn, x: torch.Tensor, bound: float, epsilon: float):
    """The 7-point stencil through ``sdf_fn`` ([M,3] -> [M,1+F])."""
    N = x.shape[0]
    offs = device_constant(tuple(map(tuple, (_FD_OFFSETS * np.float32(epsilon)).tolist())), torch.float32, x.device)
    stenciled = torch.clamp(x[None, :, :] + offs[:, None, :], -bound, bound)
    all_pts = torch.cat([x[None], stenciled], dim=0).reshape(7 * N, 3)
    out = sdf_fn(all_pts).reshape(7, N, -1)
    grad = (0.5 * (out[1:4, :, 0] - out[4:7, :, 0]) * recip(epsilon)).T
    return out[0, :, :1], out[0, :, 1:], grad


def sdf_and_gradient(params: dict, x: torch.Tensor, cfg: FieldConfig, bound: float, epsilon: float, packed: dict | None = None):
    """The reference's 7-point stencil (fd7): (sdf [N,1], feat [N,F],
    grad [N,3]) from the center and 6 central-difference taps, all 7 in one
    [7N, 3] network call (reference: models/instant_nsr.py:687-704)."""
    return _fd7(_sdf_fn(params, cfg, bound, packed), x, bound, epsilon)


def _analytic(sdf_fn, x: torch.Tensor):
    """Exact SDF spatial gradient by forward-mode autodiff: one primal
    evaluation of ``sdf_fn`` and three tangents (the unit axes), batched by
    ``torch.func.vmap`` over ``torch.func.jvp`` so that the primal runs once
    (the JAX package's jax.linearize, models/instant_nsr.py:449). The
    tangent of the encoder's interpolation reuses the primal's gathered
    corner rows: no extra table gathers, against fd4's four encoder passes.
    Reverse-mode autograd runs through the tangents, so a train step can
    backpropagate the eikonal term and the normals into the tables."""
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    out, tangents = torch.func.vmap(
        lambda t: torch.func.jvp(sdf_fn, (x,), (t.expand_as(x),)), out_dims=(None, 0)
    )(eye)
    return out[:, :1], out[:, 1:], tangents[:, :, 0].T


def stencil_sdf_grad(sdf_fn, x: torch.Tensor, bound: float, epsilon: float, mode: str):
    """(sdf [N,1], geo_feat [N,F], grad [N,3]) of ``sdf_fn`` ([M,3] ->
    [M,1+F]) under the chosen normal mode: "fd7" (the reference's central
    differences), "fd4" (the tetrahedral stencil) or "analytic" (the exact
    gradient by forward-mode autodiff; ``bound`` and ``epsilon`` unused)."""
    if mode == "fd4":
        return _tetra(sdf_fn, x, bound, epsilon)
    if mode == "fd7":
        return _fd7(sdf_fn, x, bound, epsilon)
    if mode == "analytic":
        return _analytic(sdf_fn, x)
    raise ValueError(f"unknown normal_mode: {mode!r}")


def field_sdf_grad(params: dict, x: torch.Tensor, cfg: FieldConfig, bound: float, epsilon: float, mode: str, packed: dict | None = None):
    """stencil_sdf_grad of the network field ``params``."""
    return stencil_sdf_grad(_sdf_fn(params, cfg, bound, packed), x, bound, epsilon, mode)


@dataclasses.dataclass(frozen=True)
class FieldFns:
    """Injectable field evaluation, so that one render core serves the
    network field and analytic test fields.

    sdf:   [M,3] -> [M, 1+F] (sdf value + geometry features)
    color: (x [M,3], d [M,3], n [M,3], feat [M,F]) -> [M,3]
    inv_s: () -> scalar
    """

    sdf: Callable[[torch.Tensor], torch.Tensor]
    color: Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
    inv_s: Callable[[], torch.Tensor]


def network_field_fns(params: dict, fcfg: FieldConfig, bound: float, packed: dict | None = None) -> FieldFns:
    """The network field of ``params``; ``packed``: its
    materialize_field_tables, built here when omitted (a frame builds them
    once and passes them to every chunk)."""
    if packed is None:
        packed = materialize_field_tables(params, fcfg)
    return FieldFns(
        sdf=_sdf_fn(params, fcfg, bound, packed),
        color=lambda x, d, n, f: forward_color(params, x, d, n, f, fcfg),
        inv_s=lambda: forward_variance(params),
    )


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


def cat_z_vals(sdf_fn, rays_o, rays_d, z_vals, new_z_vals, sdf, bound: float, last: bool, warp=None):
    """Merge the new z values in (sorted per ray) and, unless ``last``,
    evaluate the SDF at the new points outside autograd. ``sdf_fn``:
    [M,3] -> [M, 1+F]; ``warp``: the posed -> canonical warp of the new
    points ([B,n,3] -> (pts, dirs, mask)) before they are evaluated.
    Returns (z [B, T+n], sdf [B, T+n])."""
    B, n_new = new_z_vals.shape
    z_sorted, order = torch.sort(torch.cat([z_vals, new_z_vals], dim=-1), dim=-1, stable=True)
    if last:
        return z_sorted, sdf
    with torch.no_grad():
        pts = rays_o[:, None, :] + rays_d[:, None, :] * new_z_vals[..., None]
        if warp is not None:
            pts = warp(pts)[0]
        pts = torch.clamp(pts, -bound, bound)
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
    *,
    near_far=None,
    warp_fn=None,
    field: FieldFns | None = None,
    jitter: torch.Tensor | None = None,
    curvature_dirs: torch.Tensor | None = None,
) -> dict:
    """The importance-sampled NeuS render of rays [N,3] on their device:
    ``num_steps`` stratified samples, SDF-guided up-sampling in rounds of
    ``upsample_round`` outside autograd, midpoint resampling, one field
    evaluation with fd7 or fd4 normals, NeuS alpha compositing and the
    eikonal term (reference: models/instant_nsr.py:133-299). Same outputs
    as the JAX package's render_rays.

    ``rcfg.perturb`` jitters the stratified samples by ``jitter`` (U(0, 1)
    [N, num_steps]), drawn from ``generator`` when omitted. ``near_far``:
    per-ray (near, far) [N,1] that replace the cube bounds where finite
    (the geometry-guided bounds of an animation frame). ``warp_fn``: the
    posed -> canonical warp ([N,T,3] -> (pts, dirs, mask)), applied to the
    coarse points, each up-sampling round's new points and the midpoints;
    the mask multiplies the alphas, and the shading and the up-sampler's
    inside-sphere test keep the posed rays (reference:
    models/instant_nsr.py:175-187,245-248). ``field``: the field to
    evaluate (a frame or train step builds network_field_fns with its
    tables once; built from ``params`` when omitted). ``rcfg.curvature_loss``
    adds "curvature_error", whose random directions are ``curvature_dirs``
    [N*T, 3] or, as the JAX package draws them, 2 N(0, 1) - 1 from
    ``generator``."""
    N = rays_o.shape[0]
    bound = rcfg.bound
    num_steps = rcfg.num_steps
    if field is None:
        field = network_field_fns(params, fcfg, bound)

    def warp(pts):
        return (pts, None, None) if warp_fn is None else warp_fn(pts)

    near, far = near_far_from_bound(rays_o, rays_d, bound)
    if near_far is not None:
        ng, fg = near_far
        near = torch.where(torch.isinf(ng), near, ng)
        far = torch.where(torch.isinf(fg), far, fg)
    z_vals = stratified_z_vals(near, far, num_steps, perturb=rcfg.perturb, generator=generator, u=jitter)
    sample_dist = (far - near) * recip(num_steps)

    if rcfg.upsample_steps > 0:
        with torch.no_grad():
            pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
            pts = torch.clamp(warp(pts)[0], -bound, bound)
            sdf_cur = field.sdf(pts.reshape(-1, 3))[:, 0].reshape(N, num_steps)
        z_cur = z_vals
        n_rounds = rcfg.upsample_steps // rcfg.upsample_round
        for i in range(n_rounds):
            new_z = up_sample(rays_o, rays_d, z_cur, sdf_cur, rcfg.upsample_round, 64 * 2**i)
            z_cur, sdf_cur = cat_z_vals(
                field.sdf, rays_o, rays_d, z_cur, new_z, sdf_cur, bound, last=(i + 1 == n_rounds),
                warp=None if warp_fn is None else warp,
            )
        z_vals = z_cur
    T = rcfg.total_steps

    # midpoint resampling (reference: models/instant_nsr.py:190-208)
    deltas = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], sample_dist.expand(N, 1)], dim=-1)
    z_mid = torch.cat([z_vals[:, :-1] + 0.5 * deltas[:, :-1], z_vals[:, -1:]], dim=-1)
    new_pts = rays_o[:, None, :] + rays_d[:, None, :] * z_mid[..., None]
    dirs = rays_d[:, None, :].expand(new_pts.shape)
    new_pts, _, alpha_mask = warp(new_pts)  # the canonical directions are not used
    new_pts = torch.clamp(new_pts, -bound, bound)

    eps = 0.005 * (1.0 - rcfg.normal_epsilon_ratio)
    flat_pts = new_pts.reshape(-1, 3)
    sdf, geo_feat, gradient = stencil_sdf_grad(field.sdf, flat_pts, bound, eps, rcfg.normal_mode)
    normal = gradient / (1e-5 + _safe_norm(gradient))
    flat_dirs = dirs.reshape(-1, 3)
    color = field.color(flat_pts, flat_dirs, normal, geo_feat)
    inv_s = field.inv_s()

    true_cos = torch.sum(flat_dirs * normal, dim=-1, keepdim=True)
    iter_cos = -(
        _softplus100(-true_cos * 0.5 + 0.5) * (1.0 - rcfg.cos_anneal_ratio)
        + _softplus100(-true_cos) * rcfg.cos_anneal_ratio
    )
    flat_deltas = deltas.reshape(-1, 1)
    prev_cdf = torch.sigmoid((sdf - iter_cos * flat_deltas * 0.5) * inv_s)
    next_cdf = torch.sigmoid((sdf + iter_cos * flat_deltas * 0.5) * inv_s)
    alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0).reshape(N, T)
    if alpha_mask is not None:
        alpha = alpha * alpha_mask.reshape(N, T).to(alpha.dtype)

    trans = _transmittance(alpha)
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
    gradient_error_sum, relax_sum = (relax_inside * grad_err).sum(), relax_inside.sum()
    gradient_error = gradient_error_sum / (relax_sum + 1e-5)

    curvature_error = torch.zeros((), device=rays_o.device)
    if rcfg.curvature_loss:
        # the normal's change along a random tangent, through fd7 whatever
        # the normal mode (reference: models/instant_nsr.py:274-289)
        if curvature_dirs is None:
            curvature_dirs = 2.0 * torch.randn(normal.shape, generator=generator, device=normal.device) - 1.0
        rand_vec = curvature_dirs / (1e-5 + torch.linalg.norm(curvature_dirs, dim=-1, keepdim=True))
        perturbed = flat_pts + torch.linalg.cross(normal, rand_vec) * (0.01 * (1.0 - rcfg.normal_epsilon_ratio))
        _, _, pgrad = _fd7(field.sdf, perturbed, bound, eps)
        pnormal = pgrad / (1e-5 + _safe_norm(pgrad))
        cerr = (torch.sum(normal * pnormal, dim=-1) - 1.0) ** 2
        curvature_error = (relax_inside * cerr.reshape(N, T)).sum() / (relax_inside.sum() + 1e-5)

    image = image + (1.0 - weights_sum) * bg_color
    return {
        "rgb": image,
        "depth": depth,
        "weights": weights,
        "weight_sum": weights_sum,
        "normal": normal_map,
        "gradient_error": gradient_error,
        # its numerator and denominator, which a mesh of ranks sums before it divides
        "gradient_error_sum": gradient_error_sum,
        "gradient_relax_sum": relax_sum,
        "curvature_error": curvature_error,
        "pts_color": color,
        "pts_alpha": alpha,
        "z_vals": z_vals,
    }


def render_rays_chunked(
    params: dict,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    fcfg: FieldConfig,
    rcfg: RenderConfig,
    bg_color=1.0,
    chunk: int = 4096,
    generator: torch.Generator | None = None,
    field: FieldFns | None = None,
) -> dict:
    """``render_rays`` over any number of rays in chunks of ``chunk``
    (reference: utils/render_utils.py:514-600). As in the JAX package, the
    rays are padded to a multiple of ``chunk`` (origin (1,1,1), direction
    +z; a [N,3] background pads with ones) and ``gradient_error`` is the
    mean over the chunks, padding included. ``field``: as render_rays',
    built once here when omitted. Returns rgb [N,3], depth [N], weight_sum
    [N,1], normal [N,3] and gradient_error."""
    if field is None:
        field = network_field_fns(params, fcfg, rcfg.bound)
    n = rays_o.shape[0]
    n_pad = (-n) % chunk
    ro = torch.cat([rays_o, rays_o.new_ones((n_pad, 3))])
    rd = torch.cat([rays_d, rays_d.new_tensor([0.0, 0.0, 1.0]).expand(n_pad, 3)])
    bg_is_array = isinstance(bg_color, torch.Tensor) and bg_color.ndim == 2
    if bg_is_array:
        bg_color = torch.cat([bg_color, bg_color.new_ones((n_pad, 3))])
    keys = ("rgb", "depth", "weight_sum", "normal")
    outs = {k: [] for k in keys + ("gradient_error",)}
    for i in range(0, n + n_pad, chunk):
        bg = bg_color[i : i + chunk] if bg_is_array else bg_color
        out = render_rays(params, ro[i : i + chunk], rd[i : i + chunk], fcfg, rcfg, bg, generator, field=field)
        for k in outs:
            outs[k].append(out[k])
    result = {k: torch.cat(outs[k])[:n] for k in keys}
    result["gradient_error"] = torch.stack(outs["gradient_error"]).mean()
    return result


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
    # one fused multiply-add, as XLA fuses the JAX package's expression: a
    # depth rounded twice can move a probe across a cell face
    z_probe = torch.addcmul(near, far - near, t[None, :])
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
    field: FieldFns | None = None,
    near_far=None,
    warp_fn=None,
) -> dict:
    """Occupancy-culled NeuS render of rays [N,3] on their device: the
    network runs only on the K grid-occupied samples per ray, and with
    ``cfg.sample_budget`` only on the first ``sample_budget`` of those in
    flat order. ``field``: the field to evaluate (a frame passes
    network_field_fns with its tables built once; built from ``params``
    when omitted). ``near_far``: per-ray (near, far) [N,1] that replace the
    cube bounds where finite.

    ``warp_fn``: the posed -> canonical warp of an animation frame
    ([N,T,3] -> (pts, dirs, mask)); ``density_grid`` is then the posed-space
    grid of the frame's body. The selected samples are warped before the
    field runs, and samples off the body are masked as the reference masks
    their alphas (models/instant_nsr.py:245-248). With a budget the warp
    runs only on the compacted survivors, as one pseudo-ray. Same outputs as
    the JAX package's render_rays_fast."""
    N = rays_o.shape[0]
    K = cfg.k_samples
    bound = cfg.bound
    if field is None:
        field = network_field_fns(params, fcfg, bound)

    # profiler ranges name the stage each future kernel takes over
    with record_function("render.probe_select"):  # K1
        near, far = near_far_from_bound(rays_o, rays_d, bound)
        if near_far is not None:
            ng, fg = near_far
            near = torch.where(torch.isinf(ng), near, ng)
            far = torch.where(torch.isinf(fg), far, fg)
        z_probe, occupied = _probe_occupied(rays_o, rays_d, near, far, cfg, density_grid)
        z_sel, valid = select_occupied_samples(z_probe, occupied, K, 0.5)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_sel[..., None]
        pts = torch.clamp(pts, -bound, bound)
        flat = pts.reshape(-1, 3)
        dirs = rays_d[:, None, :].expand(pts.shape).reshape(-1, 3)
    T = flat.shape[0]

    def evaluate(x, d):
        with record_function("render.field_fd4"):  # K3 + K4
            sdf_, feat_, grad_ = stencil_sdf_grad(field.sdf, x, bound, cfg.fd_epsilon, cfg.normal_mode)
            normal_ = grad_ / (1e-5 + _safe_norm(grad_))
        with record_function("render.color"):  # K4
            color_ = field.color(x, d, normal_, feat_)
        return sdf_, grad_, normal_, color_

    if cfg.sample_budget and cfg.sample_budget < T:
        with record_function("render.compact"):  # K2
            sel, kept = compact_indices(valid.reshape(-1), cfg.sample_budget)
            n_kept = kept.sum()
            flat_c, dirs_c = flat[sel], dirs[sel]
        if warp_fn is not None:
            with record_function("render.warp"):  # K6
                # the compacted points have no ray structure: one pseudo-ray
                # (the mask is per point; the canonical dirs are not used)
                wp, _, wm = warp_fn(flat_c[None])
                flat_c = torch.clamp(wp[0], -bound, bound)
                wmask_c = wm.reshape(-1, 1).to(torch.float32)
        sdf_c, grad_c, normal_c, color_c = evaluate(flat_c, dirs_c)
        with record_function("render.scatter"):  # K2
            norm_c = torch.linalg.norm(flat_c, dim=-1, keepdim=True)
            sdf = scatter_to_flat(sdf_c, sel, T, n_kept)
            grad = scatter_to_flat(grad_c, sel, T, n_kept)
            normal = scatter_to_flat(normal_c, sel, T, n_kept)
            color = scatter_to_flat(color_c, sel, T, n_kept)
            pts_norm_flat = scatter_to_flat(norm_c, sel, T, n_kept)[:, 0]
            valid = kept.reshape(N, K)
            if warp_fn is not None:
                wmask_full = scatter_to_flat(wmask_c, sel, T, n_kept)[:, 0]
                valid = valid & (wmask_full.reshape(N, K) > 0.5)
    else:
        if warp_fn is not None:
            with record_function("render.warp"):  # K6
                wp, _, wm = warp_fn(pts)  # [N, K, 3], ray-structured
                flat = torch.clamp(wp.reshape(-1, 3), -bound, bound)
                valid = valid & wm.reshape(N, K)
        sdf, grad, normal, color = evaluate(flat, dirs)
        pts_norm_flat = torch.linalg.norm(flat, dim=-1)
    with record_function("render.composite"):  # K5
        inv_s = field.inv_s()

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

        trans = _transmittance(alpha)
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
        gradient_error_sum, relax_sum = (relax * gerr).sum(), relax.sum()
        gradient_error = gradient_error_sum / (relax_sum + 1e-5)

        return {
            "rgb": image,
            "depth": depth,
            "weights": weights,
            "weight_sum": weights_sum,
            "normal": normal_map,
            "gradient_error": gradient_error,
            "gradient_error_sum": gradient_error_sum,
            "gradient_relax_sum": relax_sum,
        }


# -- geometry extraction (reference: models/instant_nsr.py:706-764) ----------


_SDF_CHUNK = 1 << 21  # points per SDF evaluation of a mesh export (a 512^2 x 128 slab is 33.5 M)


@torch.no_grad()
def extract_sdf_grid(
    params: dict,
    fcfg: FieldConfig,
    bound: float,
    resolution: int,
    block: int = 128,
) -> np.ndarray:
    """The SDF on the [resolution]^3 lattice of linspace(-bound, bound),
    indexed [x, y, z], as a host f32 array: x-slabs of ``block`` (the JAX
    package's blocks), each evaluated on the parameters' device in point
    chunks of at most _SDF_CHUNK (each point's value is its own, so the
    chunking changes no number)."""
    chunk = _SDF_CHUNK
    device = params["variance"].device
    xs = np.linspace(-bound, bound, resolution, dtype=np.float32)
    out = np.empty((resolution,) * 3, dtype=np.float32)
    for i0 in range(0, resolution, block):
        xi = xs[i0 : i0 + block]
        gx, gy, gz = np.meshgrid(xi, xs, xs, indexing="ij")
        pts = torch.as_tensor(np.stack([gx, gy, gz], axis=-1).reshape(-1, 3), device=device)
        vals = torch.cat([density(params, pts[j : j + chunk], fcfg, bound) for j in range(0, len(pts), chunk)])
        out[i0 : i0 + block] = vals.cpu().numpy().reshape(len(xi), resolution, resolution)
    return out


def extract_geometry(
    params: dict,
    fcfg: FieldConfig,
    bound: float,
    resolution: int,
    threshold: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """(vertices [V,3] f32 in [-bound, bound], triangles [F,3] int32):
    marching cubes over -SDF on the host (the native extractor), as the
    reference's mesh export."""
    from avatarcraft_tpu_torch.utils.marching_cubes import marching_cubes

    u = -extract_sdf_grid(params, fcfg, bound, resolution)
    verts, tris = marching_cubes(u, threshold)
    verts = verts / (resolution - 1.0) * (2 * bound) - bound
    return verts.astype(np.float32), tris
