"""The per-frame fast renderer of a canonical field, the port's render
entry: gather the row-sharded grid table (the all-gather kernel), splice it
into the parameters, build the bf16 lookup tables once, then render the
frame's rays in chunks through ``render_rays_fast``.

The chunk loop pads the last chunk as the JAX package's
cli/render_canonical_cli.py:173-188 does (origin (1,1,1), direction +z).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from avatarcraft_tpu_torch.models.instant_nsr import (
    FastRenderConfig,
    FieldConfig,
    materialize_field_tables,
    render_rays_fast,
)
from avatarcraft_tpu_torch.parallel.ring import all_gather_table
from avatarcraft_tpu_torch.parallel.table_mp import shard_grid_rows


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
    """render(rays_o [N,3], rays_d [N,3]) -> {"rgb": [N,3], "depth": [N]}.

    ``params`` and ``density_grid`` live on the device the renderer runs on;
    the finest grid is split into ``n_shards`` row shards there (default:
    one, for the one card in use). ``cfg.sample_budget`` applies to each
    chunk.
    """
    params_rest, shards, splice = shard_grid_rows(params, n_shards)

    @torch.no_grad()
    def render(rays_o: torch.Tensor, rays_d: torch.Tensor) -> dict:
        with record_function("render.gather"):  # the all_gather_rows kernel
            full = splice(params_rest, all_gather_table(shards))
        with record_function("render.materialize"):
            packed = materialize_field_tables(full, fcfg)
        n = rays_o.shape[0]
        pad = (-n) % chunk
        if pad:
            rays_o = torch.cat([rays_o, rays_o.new_ones((pad, 3))])
            rays_d = torch.cat([rays_d, rays_d.new_tensor([0.0, 0.0, 1.0]).expand(pad, 3)])
        rgb, depth = [], []
        for i in range(0, n + pad, chunk):
            out = render_rays_fast(
                full, rays_o[i : i + chunk], rays_d[i : i + chunk], fcfg, cfg,
                density_grid, bg_color, packed,
            )
            rgb.append(out["rgb"])
            depth.append(out["depth"])
        return {"rgb": torch.cat(rgb)[:n], "depth": torch.cat(depth)[:n]}

    return render
