"""The per-frame renderers of a canonical field, the port's render entry:
gather the row-sharded grid table (the all-gather kernel), splice it into
the parameters, build the lookup tables once, then render the frame's rays
in chunks, through ``render_rays_fast`` (``make_fast_frame_renderer``) or
the 64+64 importance render ``render_rays_chunked``
(``make_parity_frame_renderer``, the JAX package's default sampler).

The chunk loops pad the last chunk as the JAX package's
cli/render_canonical_cli.py:173-188 and render_rays_chunked do (origin
(1,1,1), direction +z).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from avatarcraft_tpu_torch.models.instant_nsr import (
    FastRenderConfig,
    FieldConfig,
    RenderConfig,
    materialize_field_tables,
    network_field_fns,
    render_rays_chunked,
    render_rays_fast,
)
from avatarcraft_tpu_torch.parallel.ring import all_gather_table
from avatarcraft_tpu_torch.parallel.table_mp import shard_grid_rows


def gathered_field(params_rest: dict, shards, splice, fcfg: FieldConfig, bound: float):
    """(params, FieldFns) of one frame: the row-sharded table gathered (the
    all_gather_rows kernel) and spliced in, the lookup tables built once."""
    with record_function("render.gather"):  # the all_gather_rows kernel
        full = splice(params_rest, all_gather_table(shards))
    with record_function("render.materialize"):
        return full, network_field_fns(full, fcfg, bound, materialize_field_tables(full, fcfg))


def make_fast_frame_renderer(
    params: dict,
    fcfg: FieldConfig,
    cfg: FastRenderConfig,
    density_grid: torch.Tensor,
    *,
    chunk: int,
    bg_color: float = 1.0,
    n_shards: int = 1,
):
    """render(rays_o [N,3], rays_d [N,3]) -> {"rgb": [N,3], "depth": [N],
    "weight_sum": [N,1]} (the opacity).

    ``params`` and ``density_grid`` live on the device the renderer runs on;
    the finest grid is split into ``n_shards`` row shards there (default:
    one, for the one card in use). ``cfg.sample_budget`` applies to each
    chunk.
    """
    params_rest, shards, splice = shard_grid_rows(params, n_shards)

    @torch.no_grad()
    def render(rays_o: torch.Tensor, rays_d: torch.Tensor) -> dict:
        full, field = gathered_field(params_rest, shards, splice, fcfg, cfg.bound)
        n = rays_o.shape[0]
        pad = (-n) % chunk
        if pad:
            rays_o = torch.cat([rays_o, rays_o.new_ones((pad, 3))])
            rays_d = torch.cat([rays_d, rays_d.new_tensor([0.0, 0.0, 1.0]).expand(pad, 3)])
        outs = {"rgb": [], "depth": [], "weight_sum": []}
        for i in range(0, n + pad, chunk):
            out = render_rays_fast(
                full, rays_o[i : i + chunk], rays_d[i : i + chunk], fcfg, cfg,
                density_grid, bg_color, field,
            )
            for k, parts in outs.items():
                parts.append(out[k])
        return {k: torch.cat(parts)[:n] for k, parts in outs.items()}

    return render


def make_parity_frame_renderer(
    params: dict,
    fcfg: FieldConfig,
    rcfg: RenderConfig,
    *,
    chunk: int,
    bg_color: float = 1.0,
):
    """render(rays_o [N,3], rays_d [N,3]) -> {"rgb": [N,3], "depth": [N]}:
    the table gathered and the lookup tables built once per frame, then
    ``render_rays_chunked`` in chunks of ``chunk`` rays through ``rcfg``
    (the JAX package's parity frame: 64+64 samples, no jitter)."""
    params_rest, shards, splice = shard_grid_rows(params)

    @torch.no_grad()
    def render(rays_o: torch.Tensor, rays_d: torch.Tensor) -> dict:
        full, field = gathered_field(params_rest, shards, splice, fcfg, rcfg.bound)
        out = render_rays_chunked(full, rays_o, rays_d, fcfg, rcfg, bg_color, chunk=chunk, field=field)
        return {"rgb": out["rgb"], "depth": out["depth"]}

    return render
